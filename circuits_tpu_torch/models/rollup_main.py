"""RollupMain -- the full batch circuit as a batched witness evaluator.

Port of `circuits_tpu/models/rollup_main.py` (reference:
src/rollup-main.circom:82-475, phases A-H). Every DecodeTx / RollupTx
instance reads the coordinator-provided im* chain values instead of its
neighbour's outputs, so the nTx lane axis is a plain batch axis.

  build_chains()       im chains -> per-lane prev/expected arrays (len T)
  rollup_main_lanes()  phases A-E: per-lane decode + tx + integrity
  fee_phase()          phases F-G: fee txs, fee-chain integrity, per slot
  global_tail()        phases F-H: fee_phase folded, then SHA-256
  rollup_main()        all of it, and the verdict
  make_rollup_main()   rollup_main closed over the four static parameters

Input dict layout as in the JAX package (T = nTx, F = maxFeeTx,
L = nLevels): scalars (16, 1); per-tx fields (16, T); per-tx flags (T,);
bits (256, T); siblings (L+1, 16, T); im chains (16, T-1), (T-1,) and
(F, 16, T-1); fee-phase arrays (16, F).
"""

from __future__ import annotations

from functools import partial

import torch

from ..field import fr
from .decode_tx import decode_tx
from .fee_tx import fee_tx
from .hash_inputs import hash_inputs
from .rollup_tx import rollup_tx


# the per-tx arrays whose +-3/+-4 lane windows the rq-link check reads
# (src/rollup-main.circom:287-309), in the order of `neighbors`
NEIGHBOR_KEYS = ("tx_compressed_data_v2", "to_eth_addr", "to_bjj_ay")


def _neighbors(x, zero):
    """x (16, T) -> future (3, 16, T) and past (4, 16, T) neighbour stacks:
    future[j][i] = x[i+j+1], past[j][i] = x[i-j-1], zero-padded."""
    t = x.shape[-1]
    fut, past = [], []
    for j in range(3):
        pad = zero.expand(-1, min(j + 1, t))
        fut.append(torch.cat([x[:, j + 1:], pad], dim=-1))
    for j in range(4):
        pad = zero.expand(-1, min(j + 1, t))
        past.append(torch.cat([pad, x[:, :max(t - j - 1, 0)]], dim=-1))
    return torch.stack(fut), torch.stack(past)


def build_chains(inp: dict, n_tx: int, max_fee_tx: int) -> dict:
    """im* chains -> per-lane 'previous' and 'expected' arrays of length
    T. Lane i's previous values are lane i-1's im entries (lane 0 gets the
    batch-level initial values); expected values are lane i's own im
    entries (the last lane: imInitStateRootFee / imFinalAccFee)."""
    dev = inp["old_state_root"].device
    zero1 = fr.zeros((1,), dev)
    im_oc = inp["im_on_chain"].bool()
    one_flag = torch.ones((1,), dtype=torch.bool, device=dev)
    return dict(
        prev_on_chain=torch.cat([one_flag, im_oc]),
        im_oc_next=torch.cat([im_oc, ~one_flag]),
        in_idx=torch.cat([inp["old_last_idx"], inp["im_out_idx"]], dim=-1),
        old_state_root=torch.cat([inp["old_state_root"],
                                  inp["im_state_root"]], dim=-1),
        old_exit_root=torch.cat([zero1, inp["im_exit_root"]], dim=-1),
        acc_fee_in=torch.cat([torch.zeros((max_fee_tx, 16, 1),
                                          dtype=torch.int64, device=dev),
                              inp["im_acc_fee_out"]], dim=-1),
        expected_out_idx=torch.cat([inp["im_out_idx"], zero1], dim=-1),
        expected_state_root=torch.cat([inp["im_state_root"],
                                       inp["im_init_state_root_fee"]],
                                      dim=-1),
        expected_exit_root=torch.cat([inp["im_exit_root"], zero1], dim=-1),
        expected_acc_fee=torch.cat(
            [inp["im_acc_fee_out"],
             inp["im_final_acc_fee"].movedim(1, 0)[:, :, None]], dim=-1),
    )


def build_tx_inputs(inp: dict, chains: dict, dec: dict, n_tx: int,
                    max_fee_tx: int, neighbors) -> dict:
    """Assemble the RollupTx model's input dict from packed batch inputs,
    chains and decode outputs; the tx-lane axis last everywhere."""
    fut_v2, past_v2, fut_eth, past_eth, fut_ay, past_ay = neighbors
    fee_plan = inp["fee_plan_tokens"].movedim(1, 0)[:, :, None].expand(
        max_fee_tx, 16, n_tx)
    return dict(
        fee_plan_tokens=fee_plan,
        acc_fee_in=chains["acc_fee_in"],
        future_tx_v2=fut_v2, past_tx_v2=past_v2,
        future_to_eth=fut_eth, past_to_eth=past_eth,
        future_to_ay=fut_ay, past_to_ay=past_ay,
        from_idx=dec["from_idx"], aux_from_idx=inp["aux_from_idx"],
        to_idx=dec["to_idx"], aux_to_idx=inp["aux_to_idx"],
        to_bjj_ay=inp["to_bjj_ay"], to_bjj_sign=dec["to_bjj_sign"],
        to_eth_addr=inp["to_eth_addr"],
        amount=dec["amount"], token_id=dec["token_id"],
        nonce=dec["nonce"], user_fee_sel=fr.low_u32(dec["user_fee"]),
        rq_offset=inp["rq_offset"],
        on_chain=inp["on_chain"], new_account=inp["new_account"],
        rq_tx_v2=inp["rq_tx_compressed_data_v2"],
        rq_to_eth=inp["rq_to_eth_addr"], rq_to_ay=inp["rq_to_bjj_ay"],
        sig_l2_hash=dec["sig_l2_hash"],
        s=inp["s"], r8x=inp["r8x"], r8y=inp["r8y"],
        from_eth_addr=inp["from_eth_addr"],
        from_bjj_compressed=inp["from_bjj_compressed"],
        load_amount_f=inp["load_amount_f"],
        token_id1=inp["token_id1"], nonce1=inp["nonce1"],
        sign1=inp["sign1"], balance1=inp["balance1"], ay1=inp["ay1"],
        eth_addr1=inp["eth_addr1"], siblings1=inp["siblings1"],
        is_old0_1=inp["is_old0_1"], old_key1=inp["old_key1"],
        old_value1=inp["old_value1"],
        token_id2=inp["token_id2"], nonce2=inp["nonce2"],
        sign2=inp["sign2"], balance2=inp["balance2"],
        new_exit=inp["new_exit"], ay2=inp["ay2"],
        eth_addr2=inp["eth_addr2"], siblings2=inp["siblings2"],
        is_old0_2=inp["is_old0_2"], old_key2=inp["old_key2"],
        old_value2=inp["old_value2"],
        old_state_root=chains["old_state_root"],
        old_exit_root=chains["old_exit_root"],
    )


def rollup_main_lanes(inp: dict, chains: dict, n_tx: int, n_levels: int,
                      max_fee_tx: int, neighbors=None, last_mask=None,
                      debug: bool = False):
    """Phases A-E for all tx lanes. Returns (lane outputs dict, per-lane
    ok (T,)).

    `n_tx` is the width of the lane axis IN THIS CALL -- the sharded path
    (parallel/sharding.py) passes a rank's width plus `neighbors` (the six
    rq-link window stacks of `_neighbors`, cut to its lanes from the full
    width) and `last_mask` ((T,) bool, True at the globally last lane);
    single-device callers pass neither."""
    dev = inp["old_state_root"].device
    # A - binary checks: non-binary flags flip the verdict
    lane_ok = (inp["from_bjj_compressed"] <= 1).all(dim=0)
    for flag in ("on_chain", "new_account", "is_old0_1", "is_old0_2"):
        lane_ok = lane_ok & (inp[flag] <= 1)

    # B - decode
    dec, dec_ok = decode_tx(
        n_levels,
        chains["prev_on_chain"], inp["tx_compressed_data"],
        inp["max_num_batch"], inp["amount_f"], inp["to_eth_addr"],
        inp["to_bjj_ay"], inp["rq_tx_compressed_data_v2"],
        inp["rq_to_eth_addr"], inp["rq_to_bjj_ay"], inp["from_eth_addr"],
        inp["from_bjj_compressed"], inp["load_amount_f"],
        inp["global_chain_id"].expand(16, n_tx),
        inp["current_num_batch"].expand(16, n_tx),
        inp["on_chain"], inp["new_account"],
        inp["aux_from_idx"], inp["aux_to_idx"], chains["in_idx"])
    lane_ok = lane_ok & dec_ok

    # C - decode integrity
    last = (torch.arange(n_tx, device=dev) == n_tx - 1) \
        if last_mask is None else last_mask
    lane_ok = lane_ok & fr.eq(dec["tx_compressed_data_v2"],
                              inp["tx_compressed_data_v2"])
    lane_ok = lane_ok & ((inp["on_chain"].bool() == chains["im_oc_next"])
                         | last)
    lane_ok = lane_ok & (fr.eq(dec["out_idx"], chains["expected_out_idx"])
                         | last)

    # D - rollup transactions
    if neighbors is None:
        zero1 = fr.zeros((1,), dev)
        neighbors = tuple(w for k in NEIGHBOR_KEYS
                          for w in _neighbors(inp[k], zero1))
    tx_in = build_tx_inputs(inp, chains, dec, n_tx, max_fee_tx, neighbors)
    txo, tx_ok = rollup_tx(tx_in, n_levels, debug=debug)
    lane_ok = lane_ok & tx_ok

    # E + G - im integrity per lane
    lane_ok = lane_ok & fr.eq(txo["new_state_root"],
                              chains["expected_state_root"])
    lane_ok = lane_ok & (fr.eq(txo["new_exit_root"],
                               chains["expected_exit_root"]) | last)
    # (F, T) slot-wise equality -> per-lane all-slots-match
    lane_ok = lane_ok & (txo["acc_fee_out"] == chains["expected_acc_fee"]
                         ).all(dim=1).all(dim=0)

    lanes = dict(
        l1_tx_full_data=dec["l1_tx_full_data"],
        l1l2_tx_data=dec["l1l2_tx_data"],
        out_idx=dec["out_idx"],
        new_state_root=txo["new_state_root"],
        new_exit_root=txo["new_exit_root"],
        acc_fee_out=txo["acc_fee_out"],
        is_amount_nullified=txo["is_amount_nullified"],
    )
    if debug:
        lanes["decode"] = dec
        lanes["tx"] = {k: txo[k] for k in
                       ("states", "balance", "old_state_hash1",
                        "old_state_hash2", "new_state_hash1",
                        "new_state_hash2", "sig_ax", "p1_new_root",
                        "p2_new_root", "decode_ay", "decode_sign", "s1",
                        "s2", "new_nonce1", "sig_ay", "sig_sign",
                        "p1_enabled", "p2_enabled")}
    return lanes, lane_ok


def fee_phase(inp: dict, debug: bool):
    """Phases F-G: the fee transactions, batched over the maxFeeTx slots,
    and the fee chain's pins. Returns (fee root (16, F), per-slot ok (F,),
    the fee transactions' intermediates or None). A slot's ok holds its own
    constraints and its pin: slot j's output root must equal
    imStateRootFee[j] (src/rollup-main.circom:419-424). The last slot's
    root is the batch output and has no pin, so the pins are padded with
    one True slot, made on the device; at maxFeeTx = 1 there is no pin at
    all."""
    fee_old_root = torch.cat([inp["im_init_state_root_fee"],
                              inp["im_state_root_fee"]], dim=-1)
    fee_res = fee_tx(
        fee_old_root, inp["fee_plan_tokens"], inp["fee_idxs"],
        inp["im_final_acc_fee"],
        inp["token_id3"], inp["nonce3"], inp["sign3"], inp["balance3"],
        inp["ay3"], inp["eth_addr3"], inp["siblings3"], debug=debug)
    fee_root, fee_ok = fee_res[0], fee_res[1]
    chain_ok = fr.eq(fee_root[:, :-1], inp["im_state_root_fee"])
    pad = torch.ones(1, dtype=torch.bool, device=chain_ok.device)
    return (fee_root, fee_ok & torch.cat([chain_ok, pad]),
            fee_res[2] if debug else None)


def global_tail(inp: dict, lanes: dict, n_tx: int, n_levels: int,
                max_l1_tx: int, max_fee_tx: int, debug: bool = False):
    """Phases F-H: `fee_phase`, then the global SHA-256. Returns (outputs,
    ok, the fee phase's per-slot ok (F,))."""
    fee_root, fee_ok, fee_dbg = fee_phase(inp, debug=debug)
    ok_all = fee_ok.all()

    # H - global input hash
    l1_flat = lanes["l1_tx_full_data"][:, :max_l1_tx].T.reshape(-1, 1)
    l1l2 = lanes["l1l2_tx_data"]  # (2L+48, T)
    not_nullified = (~lanes["is_amount_nullified"]).long()
    amount_rows = l1l2[2 * n_levels:2 * n_levels + 40] * not_nullified
    l1l2 = torch.cat([l1l2[:2 * n_levels], amount_rows,
                      l1l2[2 * n_levels + 40:]], dim=0)
    l1l2_flat = l1l2.T.reshape(-1, 1)

    new_last_idx = lanes["out_idx"][:, -1:]
    final_state_root = fee_root[:, -1:]
    final_exit_root = lanes["new_exit_root"][:, -1:]

    h, h_ok = hash_inputs(
        n_levels, n_tx, max_l1_tx, max_fee_tx,
        inp["old_last_idx"], new_last_idx, inp["old_state_root"],
        final_state_root, final_exit_root, l1_flat, l1l2_flat,
        inp["fee_idxs"].movedim(1, 0)[:, :, None],
        inp["global_chain_id"], inp["current_num_batch"])
    ok_all = ok_all & h_ok.all()

    outputs = dict(
        hash_global_inputs=h,
        new_state_root=final_state_root,
        new_exit_root=final_exit_root,
        new_last_idx=new_last_idx,
        acc_fee_out=lanes["acc_fee_out"][:, :, -1],
    )
    if debug:
        outputs["fee"] = dict(fee_dbg, new_root=fee_root)
    return outputs, ok_all, fee_ok


def rollup_main(inp: dict, n_tx: int, n_levels: int, max_l1_tx: int,
                max_fee_tx: int):
    """Returns (outputs dict with hash_global_inputs (16, 1) and the final
    roots, ok: 0-d bool tensor)."""
    chains = build_chains(inp, n_tx, max_fee_tx)
    lanes, lane_ok = rollup_main_lanes(inp, chains, n_tx, n_levels,
                                       max_fee_tx)
    ok_all = lane_ok.all() & (inp["im_on_chain"] <= 1).all()
    out, tail_ok, _ = global_tail(inp, lanes, n_tx, n_levels, max_l1_tx,
                                  max_fee_tx)
    return out, ok_all & tail_ok


def make_rollup_main(n_tx, n_levels, max_l1_tx, max_fee_tx):
    """`rollup_main` closed over the static circuit parameters: a function
    of the packed input dict alone."""
    return partial(rollup_main, n_tx=n_tx, n_levels=n_levels,
                   max_l1_tx=max_l1_tx, max_fee_tx=max_fee_tx)
