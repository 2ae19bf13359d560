"""Withdraw -- the standalone exit-proof circuit.

Port of `circuits_tpu/models/withdraw.py` (reference:
src/withdraw.circom:21-72): HashState of the claimed leaf, an SMTVerifier
inclusion proof against rootExit, SHA-256 of the public fields. Batched
over withdrawal lanes.
"""

from __future__ import annotations

import torch

from ..ops.smt import verifier as smt_verifier
from .hash_inputs import hash_inputs_withdrawal
from .rollup_tx import hash_state


def withdraw(n_levels: int, root_exit, eth_addr, token_id, balance, idx,
             sign, ay, siblings_state, debug: bool = False):
    """Field args (16, B), sign (B,) 0/1, siblings_state (nLevels+1, 16, B).
    Returns (hash_global_inputs (16, B), ok (B,)); with debug=True a third
    intermediates dict (the witness-vector export reads it)."""
    zero = torch.zeros_like(idx)
    state = hash_state(token_id, zero, sign, balance, ay, eth_addr)
    enabled = torch.ones(idx.shape[1:], dtype=torch.bool, device=idx.device)
    ok = smt_verifier(enabled, root_exit, siblings_state, zero, zero,
                      ~enabled, idx, state, ~enabled)
    h, h_ok = hash_inputs_withdrawal(n_levels, root_exit, eth_addr,
                                     token_id, balance, idx)
    if debug:
        return h, ok & h_ok, dict(state_hash=state)
    return h, ok & h_ok
