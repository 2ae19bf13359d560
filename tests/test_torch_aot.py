"""The port's compiled engines (`circuits_tpu_torch/engine/aot.py`) on the
CPU, where there is no CUDA graph:

- the input shapes the capture allocates equal the JAX package's
  `rollup_input_shapes` and what `pack_rollup_inputs` / `pack_withdraw_inputs`
  make;
- the capture-safety mirror: a second `run_packed` of RollupMain and of
  Withdraw under a `TorchDispatchMode` records no op that a CUDA-graph
  capture refuses (a tensor made from host data, a value read back, a shape
  that depends on data). The kernels' plain versions are left out: they run
  only on the CPU, and on the card the kernels take their place;
- `CapturedCall`'s bookkeeping (copy-in, the first call op by op, the
  capture at the second, replays, cloned outputs) with the capture and
  replay steps as plain calls of the eager function: batches A, B, A and a
  tampered one, each exactly the JAX package's `RollupEngine._fn` on the
  same packed inputs; the engines route their batches through it;
- every kernel of the library's sources reports its handle, by which a
  captured graph's kernel nodes are counted on the card;
- the cached constants of `field/fr.py`, `ops/sha256.py` and
  `ops/babyjubjub.py` are never written: after two batches each equals a
  fresh build.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_aot.py -q
"""

import collections
import random

import numpy as np
import pytest
import torch

from circuits_tpu.engine import aot as jax_aot
from circuits_tpu.engine.witness import RollupEngine as JaxEngine
from circuits_tpu_torch import kernels
from circuits_tpu_torch.convert import packed_from_jax
from circuits_tpu_torch.engine import aot
from circuits_tpu_torch.engine.witness import (RollupEngine, WithdrawEngine,
                                               pack_rollup_inputs,
                                               pack_withdraw_inputs)
from circuits_tpu_torch.field import fr, scalar
from circuits_tpu_torch.ops import babyjubjub, sha256
from circuits_tpu_torch.scripts import withdraw_cases
from circuits_tpu_torch.tools.cli import example_input

from torch_capture import record_ops
from torch_compare import SUITE_CONFIG, assert_same, suite_batches

WITHDRAW_LEVELS = 16


@pytest.fixture(scope="module")
def batches():
    return suite_batches()


@pytest.fixture(scope="module")
def withdraw_lanes():
    lanes = withdraw_cases.exit_tree_batch(random.Random(7), 4,
                                           WITHDRAW_LEVELS)
    lanes.append(withdraw_cases.tamper(lanes[1], "sibling", WITHDRAW_LEVELS))
    return lanes


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", [(3, 16, 2, 2), (4, 16, 4, 2)])
def test_rollup_input_shapes_match_jax_and_pack(params):
    shapes = aot.rollup_input_shapes(*params)
    want = jax_aot.rollup_input_shapes(*params)
    assert list(shapes) == list(want)
    for k, (shape, dtype) in shapes.items():
        assert shape == tuple(want[k].shape), k
        assert dtype == torch.int64, k
    packed = pack_rollup_inputs(example_input(*params), *params,
                                device="cpu")
    assert set(packed) == set(shapes)
    for k, t in packed.items():
        assert (tuple(t.shape), t.dtype) == shapes[k], k


def test_withdraw_input_shapes_match_pack(withdraw_lanes):
    packed = pack_withdraw_inputs(withdraw_lanes, WITHDRAW_LEVELS,
                                  device="cpu")
    shapes = aot.withdraw_input_shapes(WITHDRAW_LEVELS, len(withdraw_lanes))
    assert set(packed) == set(shapes)
    for k, t in packed.items():
        assert (tuple(t.shape), t.dtype) == shapes[k], k


# ---------------------------------------------------------------------------
# Capture-safety mirror
# ---------------------------------------------------------------------------

def _rollup_run(batches):
    eng = RollupEngine(*SUITE_CONFIG, device="cpu")
    packed = eng.pack(batches["l2"].get_input())
    return lambda: eng.run_packed(packed)


def _withdraw_run(lanes):
    eng = WithdrawEngine(WITHDRAW_LEVELS, device="cpu")
    packed = eng.pack(lanes)
    return lambda: eng.run_packed(packed)


@pytest.mark.parametrize("path", ["rollup_main", "withdraw"])
def test_capture_safety_mirror(monkeypatch, batches, withdraw_lanes, path):
    run = (_rollup_run(batches) if path == "rollup_main"
           else _withdraw_run(withdraw_lanes))
    run()  # warm-up: the tables and constants are built here
    rec = record_ops(monkeypatch, run)
    print(f"{path}: {rec.count} aten ops a batch outside the plain versions "
          "of the kernels")
    assert rec.count > 1000
    assert not rec.refused, sorted(rec.refused.items())


# ---------------------------------------------------------------------------
# CapturedCall's bookkeeping, against the JAX package
# ---------------------------------------------------------------------------


def _tampered(inp):
    bad = dict(inp)
    bad["s"] = list(inp["s"])
    bad["s"][0] = (bad["s"][0] + 1) % scalar.P
    return bad


@pytest.fixture(scope="module")
def jax_packed(batches):
    jeng = JaxEngine(*SUITE_CONFIG)
    inputs = {"A": batches["l2"].get_input(),
              "B": batches["deposit"].get_input()}
    inputs["tampered"] = _tampered(inputs["A"])
    res = {}
    for k, inp in inputs.items():
        jp = jeng.pack(inp)
        res[k] = (packed_from_jax(jp, "cpu"), jeng._fn(jp))
    return res


@pytest.fixture(scope="module")
def captured_runs(jax_packed):
    """A (op by op), B (captured), A and the tampered batch (replays)
    through one CapturedCall; A's first outputs as numpy before B ran."""
    eng = RollupEngine(*SUITE_CONFIG, device="cpu")
    call = aot.CapturedCall(eng.run_packed_eager,
                            aot.rollup_input_shapes(*SUITE_CONFIG), "cpu")
    before = dict(kernels.launches)
    states = []

    def run(batch):
        out = call(jax_packed[batch][0])
        states.append((call.warm, call.outputs is not None, call.replays))
        return out

    a1 = run("A")
    a1_np = {k: v.numpy().copy() for k, v in a1[0].items()}
    b, a2, bad = run("B"), run("A"), run("tampered")
    assert kernels.launches == before
    assert states == [(True, False, 0), (True, True, 0), (True, True, 1),
                      (True, True, 2)]
    assert call.graph is None and call.nodes == 0
    return call, {"A1": a1, "A1_np": a1_np, "B": b, "A2": a2, "bad": bad}


@pytest.mark.parametrize("run,batch", [("A1", "A"), ("B", "B"), ("A2", "A"),
                                       ("bad", "tampered")])
def test_captured_call_equals_jax(jax_packed, captured_runs, run, batch):
    (out, ok), (jout, jok) = captured_runs[1][run], jax_packed[batch][1]
    assert_same(out, dict(jout), run)
    assert bool(ok) == bool(np.asarray(jok)) == (batch != "tampered")


def test_captured_call_outputs_are_not_shared(captured_runs):
    call, runs = captured_runs
    a1, a2 = runs["A1"][0], runs["A2"][0]
    for k, v in a1.items():
        assert np.array_equal(v.numpy(), runs["A1_np"][k]), k
        assert torch.equal(v, a2[k]), k
        assert v.data_ptr() != a2[k].data_ptr(), k
        assert v.data_ptr() != call.outputs[0][k].data_ptr(), k
    assert not bool(runs["bad"][1]) and bool(runs["A2"][1])


def test_captured_call_refuses_other_inputs(jax_packed, captured_runs):
    call = captured_runs[0]
    packed = jax_packed["A"][0]
    wrong = dict(packed, s=packed["s"][:, :2])
    with pytest.raises(ValueError, match="captured for"):
        call(wrong)
    with pytest.raises(ValueError, match="captured for"):
        call(dict(packed, s=packed["s"].to(torch.int32)))
    with pytest.raises(ValueError, match="missing"):
        call({k: v for k, v in packed.items() if k != "s"})
    fresh = aot.CapturedCall(lambda d: d["s"] + 1,
                             {"s": ((16, 3), torch.int64)}, "cpu")
    with pytest.raises(RuntimeError, match="before capture"):
        fresh.replay()
    fresh.capture()
    with pytest.raises(RuntimeError, match="already captured"):
        fresh.capture()


def test_engines_route_through_their_captured_call(withdraw_lanes):
    """On the CPU the engines hold a CapturedCall too: a width's first
    batch op by op, the second captured, the third replayed, each equal to
    the eager route; each Withdraw width its own call."""
    eng = WithdrawEngine(WITHDRAW_LEVELS, device="cpu")
    rollup = RollupEngine(*SUITE_CONFIG, device="cpu")
    assert isinstance(rollup.call, aot.CapturedCall)
    assert rollup.call.shapes == aot.rollup_input_shapes(*SUITE_CONFIG)
    assert rollup.call._inputs is None  # nothing allocated until a batch
    want = [eng.run_packed_eager(eng.pack(b)) for b in (withdraw_lanes,
                                                        withdraw_lanes[:2])]
    for i in range(3):
        for lanes, (h, ok) in zip((withdraw_lanes, withdraw_lanes[:2]),
                                  want):
            got_h, got_ok = eng.run_packed(eng.pack(lanes))
            assert torch.equal(got_h, h) and torch.equal(got_ok, ok)
            call = eng.calls[len(lanes)]
            assert (call.outputs is not None, call.replays) == \
                (i > 0, max(i - 1, 0))
    assert sorted(eng.calls) == [2, len(withdraw_lanes)]
    assert eng.compile(2) is eng.calls[2]


# ---------------------------------------------------------------------------
# Cached constants
# ---------------------------------------------------------------------------


def test_cached_constants_are_never_written(monkeypatch, batches,
                                            withdraw_lanes):
    """Two RollupMain and two Withdraw batches; then every entry of
    `fr._COLS`, and every padding and digit-weight table those batches
    asked for, equals a fresh build."""
    asked, tables = collections.defaultdict(set), {}
    for mod, name in ((sha256, "_padding"), (babyjubjub, "_digit_weights")):
        tables[name] = real = getattr(mod, name)

        def record(*a, _real=real, _name=name):
            asked[_name].add(a)
            return _real(*a)

        monkeypatch.setattr(mod, name, record)
    rollup, withdraw = _rollup_run(batches), _withdraw_run(withdraw_lanes)
    for _ in range(2):
        rollup()
        withdraw()
    assert fr._COLS and set(asked) == set(tables)
    for key, t in fr._COLS.items():
        assert torch.equal(t, fr._build_col(*key)), key
    for name, cached in tables.items():
        for a in asked[name]:
            assert torch.equal(cached(*a), cached.__wrapped__(*a)), (name, a)


# ---------------------------------------------------------------------------
# The kernels' handles
# ---------------------------------------------------------------------------


def test_every_kernel_reports_its_handle():
    """Each source's `ctpu_*_funcs` lists every `__global__` function of
    that source, in the order and number `kernels.FUNCS` gives them names;
    so on the card every kernel node of a captured graph is counted under
    its wrapper's name and none is missed."""
    import re

    sources = {"ctpu_poseidon_funcs": "poseidon.cu",
               "ctpu_smt_funcs": "smt.cu", "ctpu_eddsa_funcs": "eddsa.cu",
               "ctpu_sha256_funcs": "sha256.cu",
               "ctpu_rounds_funcs": "poseidon_rounds.cu",
               "ctpu_ay_sign_funcs": "ay_sign.cu"}
    assert sorted(sources) == sorted(kernels.FUNCS)
    assert set(kernels.SOURCES) - set(sources.values()) == {"mont_rate.cu"}
    assert "funcs.cuh" in kernels.HEADERS
    names = set()
    for fn, src in sources.items():
        text = (kernels.CSRC / src).read_text()
        defined = re.findall(
            r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\(",
            text)
        body = text[text.index(f'extern "C" int {fn}(void** out)'):]
        body = body[:body.index("\n}")]
        listed = re.findall(r"\(const void\*\)(\w+)", body)
        assert sorted(set(listed)) == sorted(defined), src
        assert len(listed) == len(kernels.FUNCS[fn]), src
        assert re.search(rf"kernel_funcs\(k, {len(listed)}, out\)", body)
        names.update(kernels.FUNCS[fn])
    assert names == set(kernels.launches)
