"""FeeTx -- pay one accumulated fee into the recipient leaf.

Port of `circuits_tpu/models/fee_tx.py` (reference:
src/fee-tx.circom:26-112), batched over the maxFeeTx slot axis.
"""

from __future__ import annotations

import torch

from ..field import fr
from ..ops.smt import processor as smt_processor
from .rollup_tx import hash_state_pair


def fee_tx(
    old_state_root, fee_plan_token, fee_idx, acc_fee,
    token_id, nonce, sign, balance, ay, eth_addr, siblings,
    debug: bool = False,
):
    """All field args (16, B); siblings (nLevels+1, 16, B); sign (B,).
    Returns (new_state_root, ok), plus an intermediates dict when
    debug=True."""
    fee_idx_zero = fr.is_zero(fee_idx)
    active = ~fee_idx_zero
    ok = fr.eq(fee_plan_token, token_id) | fee_idx_zero

    new_balance = fr.add(acc_fee, balance)
    old_hash, new_hash = hash_state_pair(
        (token_id, nonce, sign, balance, ay, eth_addr),
        (token_id, nonce, sign, new_balance, ay, eth_addr))

    off = torch.zeros_like(active)
    new_root, p_ok = smt_processor(
        old_state_root, siblings, fee_idx, old_hash, off, fee_idx, new_hash,
        off, active)  # fnc = UPDATE | NOP
    if debug:
        dbg = dict(old_state_hash=old_hash, new_state_hash=new_hash,
                   new_balance=new_balance)
        return new_root, ok & p_ok, dbg
    return new_root, ok & p_ok
