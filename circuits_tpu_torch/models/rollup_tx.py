"""RollupTx -- the batched per-transaction state-transition lane.

Port of `circuits_tpu/models/rollup_tx.py` (reference:
src/rollup-tx.circom:78-591, phases A-K). Every phase is batched over the
tx-lane axis; the two SMT processors run as one 2x-wide chain call.
"""

from __future__ import annotations

import torch

from ..field import fr
from ..ops import babyjubjub as bjj
from ..ops.gadgets import (bits_compressed_to_ay_sign, decode_float_bin,
                           fits_bits)
from ..ops.poseidon import poseidon
from ..ops.smt import processor_chains, processor_check
from .balance_updater import balance_updater
from .fee_accumulator import fee_accumulator
from .rq_tx_verifier import rq_tx_verifier
from .tx_states import rollup_tx_states


def hash_state(token_id, nonce, sign, balance, ay, eth_addr):
    """HashState: Poseidon(4)(tokenID + nonce*2^32 + sign*2^72, balance,
    ay, ethAddr)."""
    bshape, dev = token_id.shape[1:], token_id.device
    e0 = fr.add(token_id, fr.shift_small(nonce, 32))
    sign_f = fr.select(sign, fr.const(1 << 72, bshape, dev),
                       fr.zeros(bshape, dev))
    e0 = fr.add(e0, sign_f.expand(token_id.shape))
    return poseidon([e0, balance, ay, eth_addr])


def hash_state_pair(s1, s2):
    """Two HashState instances as one 2x-wide Poseidon(4) call. s1/s2:
    tuples of the 6 hash_state args. Returns (h1, h2)."""
    merged = [torch.cat([a, b], dim=-1) for a, b in zip(s1, s2)]
    h = hash_state(*merged)
    return h.split(s1[0].shape[-1], dim=-1)


def _feq_if(enabled, a, b):
    """ForceEqualIfEnabled as an ok-mask."""
    return fr.eq(a, b) | ~enabled


def rollup_tx(inp: dict, n_levels: int, debug: bool = False):
    """inp: dict of batched signals (snake_case names of
    src/rollup-tx.circom). Field signals (16, B); flags (B,); siblings
    (nLevels+1, 16, B); fee plan arrays (F, 16, B); bjj bits (256, B).
    Returns (outputs dict, ok (B,) bool); debug=True adds the internal
    phase signals."""
    bshape = inp["amount"].shape[1:]
    dev = inp["amount"].device
    on_chain = inp["on_chain"].bool()
    zero = fr.zeros(bshape, dev)

    # A - decode loadAmountF + tx states
    load_ok = fits_bits(inp["load_amount_f"], 40)
    load_amount = decode_float_bin(fr.bits_le(inp["load_amount_f"], 40))
    st, st_ok = rollup_tx_states(
        inp["from_idx"], inp["to_idx"], inp["to_eth_addr"],
        inp["aux_from_idx"], inp["aux_to_idx"], inp["amount"],
        inp["new_exit"], load_amount, inp["new_account"], inp["on_chain"],
        inp["from_eth_addr"], inp["eth_addr1"], inp["token_id"],
        inp["token_id1"], inp["token_id2"])
    ok = load_ok & st_ok

    # B - rq-link checks
    ok = ok & rq_tx_verifier(
        inp["future_tx_v2"], inp["past_tx_v2"],
        inp["future_to_eth"], inp["past_to_eth"],
        inp["future_to_ay"], inp["past_to_ay"],
        inp["rq_tx_v2"], inp["rq_to_eth"], inp["rq_to_ay"],
        inp["rq_offset"])

    # C - state-field checks
    ok = ok & _feq_if(~on_chain, inp["nonce"], inp["nonce1"])
    check_to = st["check_to_eth_addr"] | st["check_to_bjj"]
    ok = ok & _feq_if(check_to, inp["to_eth_addr"], inp["eth_addr2"])
    ok = ok & _feq_if(st["check_to_bjj"], inp["ay2"], inp["to_bjj_ay"])
    ok = ok & _feq_if(st["check_to_bjj"], fr.from_bool(inp["sign2"]),
                      fr.from_bool(inp["to_bjj_sign"]))
    ok = ok & _feq_if(~on_chain, inp["token_id"], inp["token_id1"])
    ok = ok & _feq_if((~on_chain) & ~st["is_p2_insert"],
                      inp["token_id"], inp["token_id2"])
    ok = ok & _feq_if(st["is_p1_insert"], inp["token_id"], inp["token_id1"])
    ok = ok & _feq_if(st["is_p1_insert"],
                      inp["from_eth_addr"], inp["eth_addr1"])

    # D - old state hashes
    old_st1, old_st2 = hash_state_pair(
        (inp["token_id1"], inp["nonce1"], inp["sign1"], inp["balance1"],
         inp["ay1"], inp["eth_addr1"]),
        (inp["token_id2"], inp["nonce2"], inp["sign2"], inp["balance2"],
         inp["ay2"], inp["eth_addr2"]))

    # E - INSERT/UPDATE mux bank
    decode_ay, decode_sign = bits_compressed_to_ay_sign(
        inp["from_bjj_compressed"])
    p1i = st["is_p1_insert"]
    s1_balance = fr.select(p1i, zero, inp["balance1"])
    s1_sign = torch.where(p1i, decode_sign, inp["sign1"].bool())
    s1_ay = fr.select(p1i, decode_ay, inp["ay1"])
    s1_nonce = fr.select(p1i, zero, inp["nonce1"])
    s1_eth = fr.select(p1i, inp["from_eth_addr"], inp["eth_addr1"])
    s1_token = fr.select(p1i, inp["token_id"], inp["token_id1"])
    s1_old_key = fr.select(p1i, inp["old_key1"], st["key1"])
    s1_old_value = fr.select(p1i, inp["old_value1"], old_st1)

    p2i = st["is_p2_insert"]
    s2_balance = fr.select(p2i, zero, inp["balance2"])
    s2_sign = torch.where(p2i, s1_sign, inp["sign2"].bool())
    s2_ay = fr.select(p2i, s1_ay, inp["ay2"])
    s2_nonce = fr.select(p2i, zero, inp["nonce2"])
    s2_eth = fr.select(p2i, s1_eth, inp["eth_addr2"])
    s2_token = fr.select(p2i, s1_token, inp["token_id2"])
    s2_old_key = fr.select(p2i, inp["old_key2"], st["key2"])
    s2_old_value = fr.select(p2i, inp["old_value2"], old_st2)

    # F - EdDSA signature
    vse = st["verify_sign_enabled"]
    sig_sign = vse & s1_sign
    sig_ay = fr.select(vse, s1_ay, zero)
    ax, ax_ok = bjj.ay_sign_to_ax(sig_ay, sig_sign)
    sig_ok = bjj.eddsa_poseidon_verify(
        vse, ax, s1_ay, inp["s"], inp["r8x"], inp["r8y"],
        inp["sig_l2_hash"])
    ok = ok & ax_ok & sig_ok

    # G - balance updater
    bal, bal_ok = balance_updater(
        s1_balance, s2_balance, inp["amount"], load_amount,
        inp["user_fee_sel"], inp["on_chain"], st["nop"],
        st["nullify_load_amount"], st["nullify_amount"])
    ok = ok & bal_ok

    # H - fee accumulator
    acc_fee_out = fee_accumulator(inp["token_id"], bal["fee2_charge"],
                                  inp["fee_plan_tokens"], inp["acc_fee_in"])

    # I - new state hashes; sender nonce +1 on L2
    new_nonce1 = fr.select(on_chain, s1_nonce,
                           fr.add(s1_nonce, fr.const(1, bshape, dev)
                                  .expand(s1_nonce.shape)))
    new_st1, new_st2 = hash_state_pair(
        (s1_token, new_nonce1, s1_sign, bal["new_balance_sender"],
         s1_ay, s1_eth),
        (s2_token, s2_nonce, s2_sign, bal["new_balance_receiver"],
         s2_ay, s2_eth))

    # J - both SMT processors as one 2x-wide chain call
    p2_active = bal["is_p2_nop"]  # circuit name; 1 = processor 2 enabled

    def cat2(a, b):
        return torch.cat([a, b], dim=-1)

    co, cn, en = processor_chains(
        cat2(inp["siblings1"], inp["siblings2"]),
        cat2(s1_old_key, s2_old_key), cat2(s1_old_value, s2_old_value),
        cat2(inp["is_old0_1"], inp["is_old0_2"]),
        cat2(st["key1"], st["key2"]), cat2(new_st1, new_st2),
        cat2(st["p1_fnc0"], st["p2_fnc0"] & p2_active),
        cat2(st["p1_fnc1"], st["p2_fnc1"] & p2_active))
    bsz = bshape[-1]
    co1, co2 = co.split(bsz, dim=-1)
    cn1, cn2 = cn.split(bsz, dim=-1)
    en1, en2 = en.split(bsz, dim=-1)

    n_sib = inp["siblings1"].shape[0]
    p1_root, p1_ok = processor_check(
        inp["old_state_root"], co1, cn1, en1, inp["siblings1"][n_sib - 1])
    ok = ok & p1_ok
    p2_old_root = fr.select(st["is_exit"], inp["old_exit_root"], p1_root)
    p2_root, p2_ok = processor_check(
        p2_old_root, co2, cn2, en2, inp["siblings2"][n_sib - 1])
    ok = ok & p2_ok

    # K - output roots
    new_state_root = fr.select(st["is_exit"], p1_root, p2_root)
    new_exit_root = fr.select(st["is_exit"], p2_root, inp["old_exit_root"])

    outputs = dict(
        acc_fee_out=acc_fee_out,
        new_state_root=new_state_root,
        new_exit_root=new_exit_root,
        is_amount_nullified=bal["is_amount_nullified"],
    )
    if debug:
        outputs.update(
            states=st,
            balance=dict(bal, load_amount=load_amount),
            old_state_hash1=old_st1, old_state_hash2=old_st2,
            new_state_hash1=new_st1, new_state_hash2=new_st2,
            sig_ax=ax, p1_new_root=p1_root, p2_new_root=p2_root,
            decode_ay=decode_ay, decode_sign=decode_sign,
            s1=dict(balance=s1_balance, sign=s1_sign, ay=s1_ay,
                    nonce=s1_nonce, eth_addr=s1_eth, token_id=s1_token,
                    old_key=s1_old_key, old_value=s1_old_value),
            s2=dict(balance=s2_balance, sign=s2_sign, ay=s2_ay,
                    nonce=s2_nonce, eth_addr=s2_eth, token_id=s2_token,
                    old_key=s2_old_key, old_value=s2_old_value),
            new_nonce1=new_nonce1, sig_ay=sig_ay, sig_sign=sig_sign,
            p1_enabled=en1, p2_enabled=en2)
    return outputs, ok
