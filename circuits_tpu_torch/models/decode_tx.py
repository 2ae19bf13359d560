"""DecodeTx -- batched transaction-field unpacking + DA bitstrings.

Port of `circuits_tpu/models/decode_tx.py` (reference:
src/decode-tx.circom:44-369). Bitstrings are (nbits, B) int64 0/1 tensors
in the circuit's output order (big-endian per field).
"""

from __future__ import annotations

import torch

from ..field import fr
from ..ops.gadgets import decode_float_bin, fits_bits
from ..ops.poseidon import poseidon

CONST_SIG = 3322668559  # src/decode-tx.circom:353

L1_TX_FULL_BITS = 160 + 256 + 48 + 40 + 40 + 32 + 48  # :73


def l1l2_bits(n_levels: int) -> int:
    return 2 * n_levels + 40 + 8  # :57


def decode_tx(
    n_levels: int,
    previous_on_chain, tx_compressed_data, max_num_batch, amount_f,
    to_eth_addr, to_bjj_ay, rq_tx_v2, rq_to_eth, rq_to_ay,
    from_eth_addr, from_bjj_compressed, load_amount_f,
    global_chain_id, current_num_batch, on_chain, new_account,
    aux_from_idx, aux_to_idx, in_idx,
):
    """All field args (16, B); from_bjj_compressed (256, B) 0/1;
    previous_on_chain / on_chain / new_account (B,) flags.
    Returns (outputs: dict, ok: (B,) bool)."""
    bshape = tx_compressed_data.shape[1:]
    dev = tx_compressed_data.device
    on_chain = on_chain.bool()
    new_account = new_account.bool()
    previous_on_chain = previous_on_chain.bool()
    not_l1 = (~on_chain).long()

    ok = fits_bits(tx_compressed_data, 225)
    data_bits = fr.bits_le(tx_compressed_data, 225)

    const_sig = fr.from_bits_le(data_bits[0:32])
    chain_id = fr.from_bits_le(data_bits[32:48])
    from_idx = fr.from_bits_le(data_bits[48:96])
    to_idx = fr.from_bits_le(data_bits[96:144])
    token_id = fr.from_bits_le(data_bits[144:176])
    nonce = fr.from_bits_le(data_bits[176:216])
    user_fee = fr.from_bits_le(data_bits[216:224])
    to_bjj_sign = data_bits[224].bool()

    pad_from = data_bits[48 + n_levels:96].bool().any(dim=0)
    pad_to = data_bits[96 + n_levels:144].bool().any(dim=0)
    ok = ok & ~pad_from & ~pad_to

    ok = ok & fits_bits(amount_f, 40)
    amount_bits = fr.bits_le(amount_f, 40)
    amount = decode_float_bin(amount_bits)

    v2_bits = torch.cat([
        data_bits[48:96] * not_l1,
        data_bits[96:144] * not_l1,
        amount_bits * not_l1,
        data_bits[144:176] * not_l1,
        data_bits[176:216] * not_l1,
        data_bits[216:224] * not_l1,
        data_bits[224:225],
    ], dim=0)
    tx_compressed_data_v2 = fr.from_bits_le(v2_bits)

    select_aux = (~on_chain) & fr.is_zero(to_idx)
    final_to_idx = fr.select(select_aux, aux_to_idx, to_idx)
    final_to_bits = fr.bits_le(final_to_idx, n_levels)

    def rev(x):
        return torch.flip(x, dims=[0])

    l1l2 = torch.cat([
        rev(data_bits[48:48 + n_levels]),
        rev(final_to_bits),
        rev(amount_bits),
        rev(data_bits[216:224] * not_l1),
    ], dim=0)

    ok = ok & fits_bits(to_eth_addr, 160) & fits_bits(max_num_batch, 32)
    element1 = fr.from_bits_le(torch.cat([
        fr.bits_le(to_eth_addr, 160),
        amount_bits,
        fr.bits_le(max_num_batch, 32),
    ], dim=0))
    sig_l2_hash = poseidon([tx_compressed_data, element1, to_bjj_ay,
                            rq_tx_v2, rq_to_eth, rq_to_ay])

    l1mask = on_chain.long()
    ok = ok & fits_bits(from_eth_addr, 160) & fits_bits(load_amount_f, 40)
    load_bits = fr.bits_le(load_amount_f, 40)
    l1full = torch.cat([
        rev(fr.bits_le(from_eth_addr, 160)),
        rev(from_bjj_compressed.long()),
        rev(data_bits[48:96]),
        rev(load_bits),
        rev(amount_bits),
        rev(data_bits[144:176]),
        rev(data_bits[96:144]),
    ], dim=0) * l1mask

    from_idx_zero = fr.is_zero(from_idx)
    ok = ok & ((on_chain & from_idx_zero) == new_account)

    create = on_chain & new_account
    out_idx = fr.select(create, fr.add(in_idx, fr.const(1, bshape, dev)),
                        in_idx)
    ok = ok & (fr.eq(aux_from_idx, out_idx) | ~create)
    ok = ok & ~((~previous_on_chain) & on_chain)

    chain_ok = fr.eq(global_chain_id, chain_id) | on_chain
    const_ok = fr.eq(const_sig, fr.const(CONST_SIG, bshape, dev)) | on_chain
    ok = ok & chain_ok & const_ok

    mnb_zero = fr.is_zero(max_num_batch)
    mnb_ok = ~fr.gt(current_num_batch, max_num_batch)
    ok = ok & (mnb_ok | mnb_zero)

    outputs = dict(
        l1l2_tx_data=l1l2,
        tx_compressed_data_v2=tx_compressed_data_v2,
        l1_tx_full_data=l1full,
        out_idx=out_idx,
        from_idx=from_idx,
        to_idx=to_idx,
        token_id=token_id,
        nonce=nonce,
        user_fee=user_fee,
        to_bjj_sign=to_bjj_sign,
        amount=amount,
        sig_l2_hash=sig_l2_hash,
    )
    return outputs, ok
