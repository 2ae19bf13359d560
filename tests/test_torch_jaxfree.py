"""The port stands alone: it runs where neither JAX nor the JAX package
can be imported (the card's machine has no JAX). A subprocess blocks every
`jax*` and `circuits_tpu` import with a meta-path finder, imports
`circuits_tpu_torch` and the engine package's re-exports, prints the
residual audit's report, builds the suite's (3, 16, 2, 2) batches with the
port's own builder, runs `RollupEngine(..., device="cpu").run`, holds the
outputs against the builder, reads its signals (`trace`), exports its
witness vector and checks it with the port's pure-Python checker, calls
each compiled debug route a second time (its capture: the engine's
`debug_call` at the export, replayed by `get_signal` and the second
export; the checker's engine's at `check_batch` of a tampered batch;
Withdraw's `run_debug`), runs a
batch of withdrawals through `WithdrawEngine` against the builder and
through a `CapturedCall` of the compiled engines' module (`engine/aot.py`,
whose input shapes it also holds), runs both plain versions of the full-round experiment against its bigint mirror, and
runs the 8-bit-limb Poseidon against K1's plain version, imports the CLI,
runs the sharded path in a world of one (gloo, in process) against the
builder, imports the two-process worker, and checks that neither `jax` nor
`circuits_tpu` ever entered `sys.modules`. A second case: the engines with no `device` ask for the card
and raise where there is none. A third: the CLI's `input`, then `witness
--device cpu`, each in its own blocked subprocess."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = textwrap.dedent("""
    import sys

    def blocked(name):
        return (name in ("jax", "jaxlib", "circuits_tpu")
                or name.startswith(("jax.", "jaxlib.", "circuits_tpu.")))

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    sys.path[:0] = sys.argv[1:3]  # the repository root, tests/
""")

SCRIPT = BLOCK + textwrap.dedent("""
    import circuits_tpu_torch  # noqa: F401
    import random

    from circuits_tpu_torch.builder.withdraw_utils import hash_inputs_withdraw
    from circuits_tpu_torch.engine import RollupEngine as Exported
    from circuits_tpu_torch.engine import aot, witness_vector
    from circuits_tpu_torch.engine.witness import RollupEngine, WithdrawEngine
    from circuits_tpu_torch.field import fr
    from circuits_tpu_torch.r1cs import audit, checker
    from circuits_tpu_torch.r1cs.checker import check_batch
    from circuits_tpu_torch.r1cs.witness_check import verify_witness
    from circuits_tpu_torch.scripts import withdraw_cases
    from circuits_tpu_torch.ops import poseidon, poseidon_mxu, poseidon_rounds
    from circuits_tpu_torch.scripts import exp_mxu_inkernel
    from circuits_tpu_torch.tools import cli  # noqa: F401
    from circuits_tpu_torch.parallel import (distributed,  # noqa: F401
                                             make_sharded_rollup_main,
                                             make_tx_mesh)
    from circuits_tpu_torch.scripts import multihost_worker  # noqa: F401
    from torch_compare import SUITE_CONFIG, oracle_outputs, suite_batches

    assert Exported is RollupEngine
    assert audit.report().startswith("reference constraint sites: ")
    engine = RollupEngine(*SUITE_CONFIG, device="cpu")
    for name, bb in suite_batches().items():
        out, ok = engine.run(bb.get_input())
        want = oracle_outputs(bb)
        assert ok, name
        assert {k: out[k] for k in want} == want, name
    inp = bb.get_input()  # the L2 batch
    tr = engine.trace(inp)
    assert tr["lane_ok"] == [True] * 3 and tr["states.key1"][0] == 256
    assert sorted(tr) == sorted(list(engine.SIGNALS) + ["lane_ok", "accFeeOut"])
    names, values = witness_vector.export_witness(engine, inp)
    assert values[1] == want["hash_global_inputs"]
    assert verify_witness(dict(zip(names, values)), *SUITE_CONFIG)["ok"]
    assert check_batch(engine.pack(inp), *SUITE_CONFIG)["ok"]
    # trace ran debug_call op by op and the export captured it: these two
    # replay it; the tampered check is the capture of the checker's
    assert engine.get_signal(inp, "states.key1[0]") == 256
    assert witness_vector.export_witness(engine, inp) == (names, values)
    bad = dict(inp, s=[(inp["s"][0] + 1) % fr.P] + list(inp["s"][1:]))
    assert check_batch(engine.pack(bad), *SUITE_CONFIG)[
        "lane_ok"].tolist() == [False, True, True]
    checks = checker.engine_for(SUITE_CONFIG, "cpu")
    assert engine.debug_call.replays == 2 and checks.debug_call.outputs \\
        is not None and checks.debug_call.replays == 0
    sharded = make_sharded_rollup_main(make_tx_mesh(1, device="cpu"),
                                       *SUITE_CONFIG)
    sout, sok = sharded(engine.pack(inp))
    assert bool(sok)
    assert fr.unpack_int(sout["hash_global_inputs"]) == \
        want["hash_global_inputs"]
    lanes = withdraw_cases.exit_tree_batch(random.Random(1), 5, 8)
    lanes.append(withdraw_cases.tamper(lanes[0], "balance", 8))
    hashes, ok = WithdrawEngine(8, device="cpu").run(lanes)
    assert ok.tolist() == [True] * 5 + [False]
    assert hashes == [hash_inputs_withdraw(d) for d in lanes]
    wdebug = WithdrawEngine(8, device="cpu")
    for _ in range(2):  # op by op, then the capture
        h, ok, dbg = wdebug.run_debug(lanes)
        assert h == hashes and ok.tolist() == [True] * 5 + [False]
    assert wdebug.debug_calls[len(lanes)].outputs is not None
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            engine.pack(inp).items()} == aot.rollup_input_shapes(*SUITE_CONFIG)
    wengine = WithdrawEngine(8, device="cpu")
    call = aot.CapturedCall(wengine.run_packed_eager,
                            aot.withdraw_input_shapes(8, len(lanes)), "cpu")
    call.capture()
    h, ok = call(wengine.pack(lanes))
    assert [int(v) for v in fr.unpack_np(h)] == hashes
    assert ok.tolist() == [True] * 5 + [False]
    state, vals = exp_mxu_inkernel.random_state(6)
    vpu = poseidon_rounds.full_rounds_vpu_plain(state, 2)
    assert bool((vpu == poseidon_rounds.full_rounds_mxu_plain(state, 2)).all())
    got = fr.unpack_np(vpu)
    for lane in range(6):
        assert [int(got[e, lane]) for e in range(3)] == \\
            poseidon_rounds.full_rounds_py([v[lane] for v in vals], 2), lane
    st = fr.to_mont(fr.pack([[0, 0], [1, fr.P - 1], [2, 0]]))
    assert bool((poseidon_mxu.permute_mont_mxu(st)
                 == poseidon.permute_mont_plain(st)).all())
    assert not any(blocked(m) for m in sys.modules), \\
        [m for m in sys.modules if blocked(m)]
    print("STANDS ALONE OK")
""")

NO_CARD_SCRIPT = BLOCK + textwrap.dedent("""
    import torch
    from circuits_tpu_torch.engine import witness
    from circuits_tpu_torch.ops import poseidon, smt
    from torch_compare import SUITE_CONFIG, suite_batches

    assert not torch.cuda.is_available()
    ran = []
    for mod, fn in ((poseidon, "permute_mont_plain"),
                    (smt, "processor_chain_plain")):
        setattr(mod, fn, lambda *a, **k: ran.append(1))
    for call in (lambda: witness.RollupEngine(4, 8, 2, 2),
                 lambda: witness.WithdrawEngine(8),
                 lambda: witness.pack_withdraw_inputs([], 8),
                 lambda: witness.pack_rollup_inputs(
                     suite_batches()["deposit"].get_input(), *SUITE_CONFIG)):
        try:
            call()
        except RuntimeError as e:
            assert "cuda" in str(e) and "cpu" in str(e), e
        else:
            raise AssertionError("ran without a card and without device")
    assert not ran, "a plain version ran on the CPU unasked"
    print("NO CARD OK")
""")


CLI_SCRIPT = BLOCK + textwrap.dedent("""
    from circuits_tpu_torch.tools import cli

    cli.main(sys.argv[3:])
    assert not any(blocked(m) for m in sys.modules), \\
        [m for m in sys.modules if blocked(m)]
""")


def _run(script, *args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", script, ROOT,
                           os.path.join(ROOT, "tests"), *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_port_runs_without_jax():
    res = _run(SCRIPT)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "STANDS ALONE OK" in res.stdout


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without a card")
    res = _run(NO_CARD_SCRIPT)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO CARD OK" in res.stdout


def test_cli_runs_without_jax(tmp_path):
    params = ["4", "16", "4", "2"]
    res = _run(CLI_SCRIPT, "input", "4", "2", *params, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    expected = res.stdout.strip().rsplit("= ", 1)[1].rstrip(")")
    res = _run(CLI_SCRIPT, "witness", "inputs-4.json", "out.json", *params,
               "--device", "cpu", cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["ok"] is True
    assert out["outputs"]["hash_global_inputs"] == expected
