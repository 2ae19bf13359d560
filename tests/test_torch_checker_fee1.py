"""The verdict at maxFeeTx = 1, where the fee chain has no im pin: the
port's `check_batch` (its engine's `debug_call`: op by op, then the
capture), `check_batch_sharded` in a world of one (gloo, in process) and
`RollupEngine(..., device="cpu").run` against the JAX package's
`check_batch` and `RollupEngine.run`, at RollupMain(2, 16, 1, 1) on a
valid batch and on the same batch with the fee recipient's balance3 + 7.
The batch is `chip_smoke.production_batch(2, 16, 1, 1)`, the one that
`chip_smoke.py` checks on the card. `fee_ok` has one slot, True on the
valid batch and False on the tampered one; `ok`, `lane_ok` and `fee_ok`
equal JAX's. Exact. A file of its own, so that its JAX compiles at this
shape get a worker of their own."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import FEE1_CONFIG as CONFIG, production_batch
from circuits_tpu.engine.witness import RollupEngine as JRollupEngine
from circuits_tpu.engine.witness import pack_rollup_inputs as j_pack
from circuits_tpu.r1cs.checker import check_batch as j_check_batch
from circuits_tpu_torch.engine import RollupEngine
from circuits_tpu_torch.engine.witness import pack_rollup_inputs
from circuits_tpu_torch.parallel import make_tx_mesh
from circuits_tpu_torch.r1cs import checker
from circuits_tpu_torch.r1cs.checker import check_batch, check_batch_sharded

from torch_compare import one_thread, oracle_outputs  # noqa: F401
# (one_thread: autouse)

CASES = {"valid": [True], "fee slot tampered": [False]}


@pytest.fixture(scope="module")
def results():
    """{case: {route: result}} of both packages; the checker's engine is
    made fresh, since the checker keeps its engines as long as the
    process."""
    checker._ENGINES.pop((CONFIG, torch.device("cpu")), None)
    bb = production_batch(*CONFIG)
    valid = bb.get_input()
    bad = dict(valid, balance3=[valid["balance3"][0] + 7])
    engine = RollupEngine(*CONFIG, device="cpu")
    jengine = JRollupEngine(*CONFIG)
    created = not dist.is_initialized()
    mesh = make_tx_mesh(1, device="cpu")
    res = {}
    try:
        for case, inp in zip(CASES, (valid, bad)):
            packed = pack_rollup_inputs(inp, *CONFIG, device="cpu")
            res[case] = dict(
                check_batch=check_batch(packed, *CONFIG),
                check_batch_sharded=check_batch_sharded(mesh, packed,
                                                        *CONFIG),
                jax=j_check_batch(j_pack(inp, *CONFIG), *CONFIG),
                run=engine.run(inp), jax_run=jengine.run(inp))
    finally:
        if created:
            dist.destroy_process_group()
    return res, oracle_outputs(bb)


@pytest.mark.parametrize("route", ["check_batch", "check_batch_sharded"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_check_at_max_fee_tx_1_matches_jax(results, case, route):
    got, want = results[0][case][route], results[0][case]["jax"]
    assert want["fee_ok"].tolist() == CASES[case]
    assert got["fee_ok"].shape == want["fee_ok"].shape == (1,)
    for mask in ("lane_ok", "fee_ok"):
        assert got[mask].dtype == np.bool_
        assert got[mask].tolist() == want[mask].tolist()
    assert got["lane_ok"].tolist() == [True, True]
    assert got["ok"] is want["ok"] is (case == "valid")


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_at_max_fee_tx_1_matches_jax(results, case):
    (out, ok), (jout, jok) = (results[0][case][k] for k in ("run", "jax_run"))
    assert ok is bool(jok) is (case == "valid")
    if case == "valid":
        want = results[1]
        assert {k: out[k] for k in want} == want
        assert {k: jout[k] for k in want} == want
