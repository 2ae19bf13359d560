"""RqTxVerifier -- atomic-link (rqOffset) checks between neighbour txs.

Port of `circuits_tpu/models/rq_tx_verifier.py` (reference:
src/rq-tx-verifier.circom:19-94).
"""

from __future__ import annotations

import torch

from ..field import fr


def _mux8(sel_bits, options):
    """options: list of 8 (16, B) tensors; sel_bits: (3, B) 0/1."""
    lvl1 = [fr.select(sel_bits[0], options[2 * i + 1], options[2 * i])
            for i in range(4)]
    lvl2 = [fr.select(sel_bits[1], lvl1[2 * i + 1], lvl1[2 * i])
            for i in range(2)]
    return fr.select(sel_bits[2], lvl2[1], lvl2[0])


def rq_tx_verifier(
    future_tx_v2, past_tx_v2, future_to_eth, past_to_eth,
    future_to_ay, past_to_ay, rq_tx_v2, rq_to_eth, rq_to_ay, rq_offset,
):
    """future_*: (3, 16, B); past_*: (4, 16, B); rq_*: (16, B);
    rq_offset: (B,) in 0..7. Returns ok (B,) bool. Offset 1..3 selects
    future[0..2], 4..7 past[3..0]."""
    zero = fr.zeros(rq_tx_v2.shape[1:], rq_tx_v2.device)
    sel = torch.stack([(rq_offset.long() >> i) & 1 for i in range(3)])

    def table(fut, past):
        return [zero, fut[0], fut[1], fut[2], past[3], past[2], past[1],
                past[0]]

    ok = fr.eq(_mux8(sel, table(future_tx_v2, past_tx_v2)), rq_tx_v2)
    ok = ok & fr.eq(_mux8(sel, table(future_to_eth, past_to_eth)), rq_to_eth)
    return ok & fr.eq(_mux8(sel, table(future_to_ay, past_to_ay)), rq_to_ay)
