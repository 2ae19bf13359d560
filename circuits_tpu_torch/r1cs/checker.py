"""Constraint-satisfaction checking.

Port of `circuits_tpu/r1cs/checker.py`: `check_batch` on one device and
`check_batch_sharded` with the tx lanes cut over a mesh of ranks. The
reference delegates "is this witness valid" to the R1CS and snarkjs
(`Az o Bz = Cz`); this engine enforces the same relations as residuals
evaluated during witness computation: every circom `===` /
ForceEqualIfEnabled / Num2Bits range constraint appears as a boolean mask.
Both expose the per-lane and per-fee-slot masks for debugging, mirroring
the reference's negative tests that expect "Constraint doesn't match"
(test/rollup-main.test.js:679-684, 866-877).

`check_batch` runs its device part (`check_masks`) through a
`CapturedCall` (`engine/aot.py`) cached per circuit and device, as the JAX
package runs it as one jitted program: a shape's first check runs op by
op, the second captures a CUDA graph, later ones replay it; the host reads
of the masks stay outside the graph. `check_batch_sharded` stays op by op:
two ranks on one card talk over gloo, whose collectives cannot be
captured.
"""

from __future__ import annotations

from functools import partial

import torch

from ..engine.aot import (CapturedCall, graph_pool, pinned_device,
                          rollup_input_shapes)
from ..field import fr
from ..models.fee_tx import fee_tx
from ..models.rollup_main import build_chains, rollup_main_lanes
from ..parallel import sharding

# (circuit params, device) -> the compiled `check_masks`; device -> the
# memory pool all of that device's checks capture into
_CALLS: dict[tuple, CapturedCall] = {}
_POOLS: dict[torch.device, object] = {}


def _fee_ok(packed: dict) -> torch.Tensor:
    """The fee phase's per-slot mask (maxFeeTx,), on every slot's own
    constraints and on the fee chain."""
    fee_old_root = torch.cat([packed["im_init_state_root_fee"],
                              packed["im_state_root_fee"]], dim=-1)
    fee_root, fee_ok = fee_tx(
        fee_old_root, packed["fee_plan_tokens"], packed["fee_idxs"],
        packed["im_final_acc_fee"], packed["token_id3"], packed["nonce3"],
        packed["sign3"], packed["balance3"], packed["ay3"],
        packed["eth_addr3"], packed["siblings3"])
    # per-slot fee-chain integrity: slot j's output root must equal
    # imStateRootFee[j] (the last slot's root is the batch output and has
    # no im pin) -- keeps the mask slot-local so a corrupted fee slot is
    # attributable (src/rollup-main.circom:419-424); the pad is one slot
    # even at maxFeeTx = 1, where chain_ok is empty
    chain_ok = fr.eq(fee_root[:, :-1], packed["im_state_root_fee"])
    pad = torch.ones(1, dtype=torch.bool, device=chain_ok.device)
    return fee_ok & torch.cat([chain_ok, pad])


def check_masks(packed: dict, n_tx: int, n_levels: int,
                max_fee_tx: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The device part of `check_batch`: (lane_ok (nTx,), fee_ok
    (maxFeeTx,)) bool tensors on the device of `packed`."""
    chains = build_chains(packed, n_tx, max_fee_tx)
    _, lane_ok = rollup_main_lanes(packed, chains, n_tx, n_levels,
                                   max_fee_tx)
    return lane_ok, _fee_ok(packed)


def compiled_check(params: tuple, device) -> CapturedCall:
    """The compiled `check_masks` of RollupMain(*params) on `device`, made
    at first use and kept for the process, as jit keeps its program a
    shape; every one on a device captures into that device's pool."""
    device = pinned_device(device)
    key = (tuple(params), device)
    if key not in _CALLS:
        if device not in _POOLS:
            _POOLS[device] = graph_pool(device)
        n_tx, n_levels, _, max_fee_tx = params
        _CALLS[key] = CapturedCall(
            partial(check_masks, n_tx=n_tx, n_levels=n_levels,
                    max_fee_tx=max_fee_tx),
            rollup_input_shapes(*params), device, pool=_POOLS[device],
            route="check")
    return _CALLS[key]


def check_batch(packed: dict, n_tx: int, n_levels: int, max_l1_tx: int,
                max_fee_tx: int) -> dict:
    """packed: `pack_rollup_inputs`' tensors (their device decides where
    this runs). Returns dict(ok, lane_ok (nTx,), fee_ok (maxFeeTx,)) as
    host numpy -- which lane / fee slot violated a constraint."""
    call = compiled_check((n_tx, n_levels, max_l1_tx, max_fee_tx),
                          packed["old_state_root"].device)
    lane_ok, fee_ok = (fr.to_numpy(m) for m in call(packed))
    return dict(ok=bool(lane_ok.all() and fee_ok.all()),
                lane_ok=lane_ok, fee_ok=fee_ok)


def check_batch_sharded(mesh, packed: dict, n_tx: int, n_levels: int,
                        max_l1_tx: int, max_fee_tx: int) -> dict:
    """`check_batch` with the tx lanes cut over `mesh`
    (`parallel.make_tx_mesh`): every rank is handed the whole batch and
    checks its own lanes; the verdict is an all-reduce of the failure
    counts, the fee phase runs on every rank, and the per-lane mask is
    gathered whole. Every rank returns the same dict(ok, lane_ok (nTx,),
    fee_ok (maxFeeTx,)), host numpy."""
    t_loc = sharding.lanes_per_rank(mesh, n_tx)
    chains = build_chains(packed, n_tx, max_fee_tx)
    inp, ch = sharding.local_lanes(mesh, packed, chains, t_loc)
    _, lane_ok, n_bad = sharding.sharded_lanes(inp, ch, n_tx, t_loc,
                                               n_levels, max_fee_tx, mesh)
    fee_ok = _fee_ok(inp)
    lane_ok = sharding.gather_lanes(lane_ok, 0, mesh)
    return dict(ok=bool((n_bad == 0) & fee_ok.all()),
                lane_ok=fr.to_numpy(lane_ok), fee_ok=fr.to_numpy(fee_ok))
