"""Two processes, one tx-lane mesh: the port's sharded RollupMain over gloo
on the CPU, against the builder and the JAX package, exactly.

Two `circuits_tpu_torch.scripts.multihost_worker` processes (ranks 0 and
1, lanes 0-1 and 2-3) read one batch file with the three batches of
`torch_compare.rq_batches` at RollupMain(4, 16, 2, 2), whose rq-linked pair
sits on lanes 1 and 2, across the ranks' boundary: only a right all-gather
of the rq-link windows lets "past" and "future" pass and "switched" fail.
Each rank runs every batch and `check_batch_sharded` on it. Meanwhile this
process runs the JAX package's `make_sharded_rollup_main` and
`check_batch_sharded` on a 2-device mesh of conftest's virtual CPU devices,
fed the same packed numpy. Both ranks must give the same results, equal to
JAX's limb for limb and, for the valid batches, to the builder's hash and
new state root.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from circuits_tpu.engine.witness import pack_rollup_inputs as j_pack
from circuits_tpu.parallel.sharding import (make_sharded_rollup_main,
                                            make_tx_mesh)
from circuits_tpu.r1cs.checker import check_batch_sharded
from circuits_tpu_torch.convert import packed_from_jax
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.scripts.multihost_worker import write_batches

from torch_compare import RQ_CONFIG, rq_batches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["past", "switched", "future"]
VALID = {"past": True, "switched": False, "future": True}
TIMEOUT_S = 400  # a hung collective fails the test instead of hanging it


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' results, JAX's (outputs, ok) and check dicts, the
    builder batches), each keyed by batch name."""
    batches = rq_batches()
    jpacked = {k: j_pack(batches[k].get_input(), *RQ_CONFIG) for k in NAMES}
    path = tmp_path_factory.mktemp("multihost") / "batches.pt"
    packed = [packed_from_jax(jpacked[k]) for k in NAMES]
    write_batches(path, RQ_CONFIG, packed, packed)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # one intra-op thread a rank: the plain versions' tensors are tiny, and
    # the ranks share the host's cores with the JAX reference below
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-m",
         "circuits_tpu_torch.scripts.multihost_worker", str(rank), "2",
         str(port), str(path), "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    try:
        mesh = make_tx_mesh(2)
        run = make_sharded_rollup_main(mesh, *RQ_CONFIG)
        jax_runs = {k: run(jpacked[k]) for k in NAMES}
        jax_checks = {k: check_batch_sharded(mesh, jpacked[k], *RQ_CONFIG)
                      for k in NAMES}
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        lines = out.splitlines()
        res = json.loads([ln for ln in lines
                          if ln.startswith("MULTIHOST_RESULT ")][0].split(
                              " ", 1)[1])
        assert res["rank"] == rank and res["device"] == "cpu"
        assert f"MULTIHOST_OK {rank} {res['runs'][0]['hash']}" in lines
        ranks.append({k: (run_, check) for k, run_, check
                      in zip(NAMES, res["runs"], res["checks"])})
    return ranks, jax_runs, jax_checks, batches


@pytest.mark.parametrize("name", NAMES)
def test_both_ranks_agree_and_valid_batches_equal_builder(runs, name):
    ranks, _, _, batches = runs
    (run, check), (run1, check1) = ranks[0][name], ranks[1][name]
    timeless = lambda r: {k: v for k, v in r.items() if k != "seconds"}
    assert timeless(run) == timeless(run1)
    assert timeless(check) == timeless(check1)
    assert run["ok"] is VALID[name] and check["ok"] is VALID[name]
    if VALID[name]:
        assert run["hash"] == batches[name].get_hash_inputs()
        assert fr.unpack_int(np.array(run["outputs"]["new_state_root"])) \
            == batches[name].get_new_state_root()


@pytest.mark.parametrize("name", NAMES)
def test_outputs_and_ok_equal_jax(runs, name):
    ranks, jax_runs, _, _ = runs
    jout, jok = jax_runs[name]
    for rank in ranks:
        run = rank[name][0]
        assert run["ok"] is bool(jok)
        assert sorted(run["outputs"]) == sorted(jout)
        for k, v in jout.items():
            assert np.array_equal(np.array(run["outputs"][k], np.int64),
                                  np.asarray(v).astype(np.int64)), k


@pytest.mark.parametrize("name", NAMES)
def test_check_masks_equal_jax(runs, name):
    ranks, _, jax_checks, _ = runs
    want = jax_checks[name]
    for rank in ranks:
        check = rank[name][1]
        assert check["ok"] is want["ok"]
        assert check["lane_ok"] == want["lane_ok"].tolist()
        assert check["fee_ok"] == want["fee_ok"].tolist()
    bad = np.flatnonzero(~want["lane_ok"]).tolist()
    assert bad == ([] if VALID[name] else [1])
