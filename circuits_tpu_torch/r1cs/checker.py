"""Constraint-satisfaction checking.

Port of `circuits_tpu/r1cs/checker.py`: `check_batch` on one device and
`check_batch_sharded` with the tx lanes cut over a mesh of ranks. The
reference delegates "is this witness valid" to the R1CS and snarkjs
(`Az o Bz = Cz`); this engine enforces the same relations as residuals
evaluated during witness computation: every circom `===` /
ForceEqualIfEnabled / Num2Bits range constraint appears as a boolean mask.
Both expose the per-lane and per-fee-slot masks for debugging, mirroring
the reference's negative tests that expect "Constraint doesn't match"
(test/rollup-main.test.js:679-684, 866-877). The fee slots' mask is
`models.rollup_main.fee_phase`'s, the rule the circuit's verdict folds.

`check_batch` reads the masks from the debug evaluation of a
`RollupEngine` kept per circuit and device (`engine_for`), as the JAX
package runs its check as one jitted program: its `debug_call` runs a
shape's first check op by op, captures a CUDA graph at the second and
replays it after; the host reads of the masks stay outside the graph. A
caller that also traces or exports that circuit on that device may take
the same engine, so that one graph serves all three.
`check_batch_sharded` stays op by op: two ranks on one card talk over
gloo, whose collectives cannot be captured.
"""

from __future__ import annotations

from ..engine.aot import pinned_device
from ..engine.witness import RollupEngine
from ..field import fr
from ..models.rollup_main import build_chains, fee_phase
from ..parallel import sharding

# (circuit params, device) -> the engine whose `debug_call` checks that
# circuit's batches on that device, kept for the process
_ENGINES: dict[tuple, RollupEngine] = {}


def engine_for(params: tuple, device) -> RollupEngine:
    """The `RollupEngine` of RollupMain(*params) on `device` that
    `check_batch` runs, made at first use and kept for the process, as jit
    keeps its program a shape."""
    device = pinned_device(device)
    key = (tuple(params), device)
    if key not in _ENGINES:
        _ENGINES[key] = RollupEngine(*params, device=device)
    return _ENGINES[key]


def check_batch(packed: dict, n_tx: int, n_levels: int, max_l1_tx: int,
                max_fee_tx: int) -> dict:
    """packed: `pack_rollup_inputs`' tensors (their device decides where
    this runs). Returns dict(ok, lane_ok (nTx,), fee_ok (maxFeeTx,)) as
    host numpy -- which lane / fee slot violated a constraint."""
    engine = engine_for((n_tx, n_levels, max_l1_tx, max_fee_tx),
                        packed["old_state_root"].device)
    _, lane_ok, _, _, fee_ok = engine.debug_call(packed)
    lane_ok, fee_ok = fr.to_numpy(lane_ok), fr.to_numpy(fee_ok)
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
    _, fee_ok, _ = fee_phase(inp, debug=False)
    lane_ok = sharding.gather_lanes(lane_ok, 0, mesh)
    return dict(ok=bool((n_bad == 0) & fee_ok.all()),
                lane_ok=fr.to_numpy(lane_ok), fee_ok=fr.to_numpy(fee_ok))
