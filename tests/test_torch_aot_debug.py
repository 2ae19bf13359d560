"""The port's compiled debug routes (`engine/aot.py:CapturedCall`) on the
CPU, where there is no CUDA graph, against the JAX package's jitted ones,
at the suite's config (3, 16, 2, 2) and on Withdraw(16) x 5 lanes:

- `RollupEngine._trace_lanes` (which `trace` and `get_signal` read) and
  `_full_debug` (the witness-vector export), both read from the engine's
  one `debug_call`, in turns on batches A, B, A -- the first call op by
  op, the capture, replays -- and `WithdrawEngine.run_debug`
  (`debug_call_for`) on A, B, A: every leaf equal limb for limb to JAX's
  `_trace_lanes`, `_full_debug` and `run_debug` (`check_batch`, which
  reads the same `debug_call` of an engine the checker keeps, is held with
  a tampered batch through its replay in `tests/test_torch_checker.py`);
- `trace`, `get_signal`, `_full_debug`, `export_witness` and `handoff`
  each one call of `debug_call` and of nothing else;
- the capture-safety mirror (`tests/torch_capture.py`) on the two debug
  device functions, `RollupEngine.debug_eager` (the check's masks
  included) and `withdraw(debug=True)`;
- `CapturedCall` with trees whose leaves are no tensors, are one tensor
  twice, or are a static input passed through: the clones stay right when
  the next batch is loaded and share memory with nothing; a debug route
  given inputs of another shape refuses them as `run_packed` does.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_aot_debug.py -q
"""

import random

import numpy as np
import pytest
import torch

from circuits_tpu.engine.witness import (RollupEngine as JaxEngine,
                                         WithdrawEngine as JaxWithdrawEngine)
from circuits_tpu_torch import convert
from circuits_tpu_torch.engine import aot, witness_vector
from circuits_tpu_torch.engine.witness import RollupEngine, WithdrawEngine
from circuits_tpu_torch.scripts import withdraw_cases

from torch_capture import record_ops
from torch_compare import (SUITE_CONFIG, assert_same,  # noqa: F401
                           one_thread, suite_batches)  # one_thread: autouse

WITHDRAW_LEVELS = 16
WITHDRAW_WIDTH = 5
RUNS = [("A1", "A"), ("B", "B"), ("A2", "A")]
# what a route's CapturedCall holds after each of A, B, A: (warm,
# captured, replays)
STATES = [(True, False, 0), (True, True, 0), (True, True, 1)]
# what RollupMain's one debug_call holds after each call of a route, the
# two routes in turns on A, B, A: trace first
TURNS = {"trace": [(True, False, 0), (True, True, 1), (True, True, 3)],
         "debug": [(True, True, 0), (True, True, 2), (True, True, 4)]}


@pytest.fixture(scope="module")
def inputs():
    batches = suite_batches()
    a = batches["l2"].get_input()
    return {"A": a, "B": batches["deposit"].get_input()}


@pytest.fixture(scope="module")
def rollup_runs(inputs):
    """A, B, A through one engine's `_trace_lanes` and `_full_debug`, the
    two routes in turns; each result as numpy right after its call, and the
    tensors themselves, with `debug_call`'s state after each call."""
    eng = RollupEngine(*SUITE_CONFIG, device="cpu")
    runs, states = {}, {"trace": [], "debug": []}
    call = eng.debug_call
    for run, batch in RUNS:
        for route, fn in (("trace", eng._trace_lanes),
                          ("debug", eng._full_debug)):
            out = fn(inputs[batch])
            runs[route, run] = (out, convert.debug_to_numpy(out))
            states[route].append((call.warm, call.outputs is not None,
                                  call.replays))
    return eng, runs, states


@pytest.fixture(scope="module")
def jax_rollup(inputs):
    jeng = JaxEngine(*SUITE_CONFIG)
    return {(route, batch): (jeng._trace_lanes(inputs[batch]) if
                             route == "trace" else
                             jeng._full_debug(inputs[batch]))
            for route in ("trace", "debug") for batch in ("A", "B")}


@pytest.mark.parametrize("run,batch", RUNS)
@pytest.mark.parametrize("route", ["trace", "debug"])
def test_debug_route_equals_jax(rollup_runs, jax_rollup, route, run, batch):
    got = rollup_runs[1][route, run][1]
    want = jax_rollup[route, batch]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"{route}[{i}]")
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)


@pytest.mark.parametrize("route", ["trace", "debug"])
def test_debug_routes_capture_at_the_second_call(rollup_runs, route):
    eng, runs, states = rollup_runs
    assert states[route] == TURNS[route]
    call = eng.debug_call
    assert call.shapes == aot.rollup_input_shapes(*SUITE_CONFIG)
    assert call.pool is eng.call.pool and call.graph is None
    assert eng.call._inputs is None  # the main call never ran
    # each run's clones kept A's values after B was loaded, and differ
    _, a1 = runs[route, "A1"]
    assert_same(runs[route, "A1"][0], a1)
    assert_same(runs[route, "A2"][0], a1)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_debug_outputs_are_not_shared(rollup_runs):
    """No leaf of a returned tree shares memory with another run's, with
    the static outputs or with the static inputs; leaves that are one
    tensor in the eager tree (`out_idx` and `decode.out_idx`) come back as
    two clones."""
    eng, runs, _ = rollup_runs
    call = eng.debug_call
    static = {t.untyped_storage().data_ptr() for t in
              list(_leaves(call.outputs)) + list(call.inputs.values())}
    seen = set()
    for (route, run), (out, _) in runs.items():
        ptrs = [t.untyped_storage().data_ptr() for t in _leaves(out)]
        assert len(set(ptrs)) == len(ptrs), (route, run)
        assert not set(ptrs) & static, (route, run)
        assert not set(ptrs) & seen, (route, run)
        seen |= set(ptrs)
    lanes = runs["debug", "A2"][0][0]
    assert torch.equal(lanes["out_idx"], lanes["decode"]["out_idx"])
    assert lanes["out_idx"] is not lanes["decode"]["out_idx"]


def test_debug_routes_refuse_other_inputs(rollup_runs, inputs):
    eng = rollup_runs[0]
    packed = eng.pack(inputs["A"])
    with pytest.raises(ValueError, match="captured for"):
        eng.debug_call(dict(packed, s=packed["s"][:, :2]))
    with pytest.raises(ValueError, match="missing"):
        eng.debug_call({k: v for k, v in packed.items() if k != "s"})


def test_entry_points_read_debug_call_alone(rollup_runs, inputs, tmp_path,
                                            monkeypatch):
    """`trace`, `get_signal`, `_full_debug`, `export_witness` and `handoff`
    on the engine whose `debug_call` the fixture captured: each is one
    replay of it, loads A and runs nothing else of the circuit (the engine
    holds no other CapturedCall than its main call, which never ran). The
    fixture's last call was `_full_debug` of A, so the static outputs hold
    A's evaluation; the replays here run a stand-in that returns it, so
    that the test costs no evaluation of its own."""
    eng = rollup_runs[0]
    inp = inputs["A"]
    calls = [v for v in vars(eng).values() if isinstance(v, aot.CapturedCall)]
    assert calls == [eng.call, eng.debug_call]
    call, packed = eng.debug_call, eng.pack(inp)
    assert all(torch.equal(call.inputs[k], v) for k, v in packed.items())
    evaluation, ran = aot._tree_map(torch.clone, call.outputs), []

    def replayed(static_inputs):
        assert static_inputs is call.inputs
        assert all(torch.equal(static_inputs[k], v)
                   for k, v in packed.items())
        ran.append(1)
        return evaluation

    monkeypatch.setattr(call, "fn", replayed)
    path = tmp_path / "a.wtns"
    entries = {
        "trace": lambda: eng.trace(inp),
        "get_signal": lambda: eng.get_signal(inp, "states.key1[0]"),
        "_full_debug": lambda: eng._full_debug(inp),
        "export_witness": lambda: witness_vector.export_witness(eng, inp),
        "handoff": lambda: witness_vector.handoff(eng, inp, path),
    }
    got = {}
    for i, (name, entry) in enumerate(entries.items()):
        replays = call.replays
        got[name] = entry()
        assert (call.warm, call.outputs is not None, call.replays) == \
            (True, True, replays + 1), name
        assert len(ran) == i + 1, name
    assert eng.call._inputs is None and eng.call.outputs is None
    lanes, lane_ok, out, ok = rollup_runs[1]["debug", "A2"][0]
    assert_same(evaluation[:4], (lanes, lane_ok, out, ok))
    assert bool(ok)
    trace = got["trace"]
    assert trace["lane_ok"] == lane_ok.tolist() == [True] * SUITE_CONFIG[0]
    assert got["get_signal"] == trace["states.key1"][0]
    assert_same(got["_full_debug"], (lanes, lane_ok, out, ok))
    names, values = got["export_witness"]
    assert names == witness_vector.signal_names(*SUITE_CONFIG)
    outputs, handed = got["handoff"]
    assert handed and path.exists()
    assert outputs["hash_global_inputs"] == values[1] == \
        eng.unpack_outputs(out)["hash_global_inputs"]


# ---------------------------------------------------------------------------
# Withdraw's run_debug
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def withdraw_runs():
    """Two batches of 5 lanes (one tampered lane each), A, B, A through
    one engine's `run_debug`, and JAX's `run_debug` of A and B."""
    a = withdraw_cases.exit_tree_batch(random.Random(7), 4, WITHDRAW_LEVELS)
    a.append(withdraw_cases.tamper(a[1], "sibling", WITHDRAW_LEVELS))
    b = withdraw_cases.exit_tree_batch(random.Random(8), 4, WITHDRAW_LEVELS)
    b.insert(2, withdraw_cases.tamper(b[0], "balance", WITHDRAW_LEVELS))
    lanes = {"A": a, "B": b}
    eng = WithdrawEngine(WITHDRAW_LEVELS, device="cpu")
    runs, states = {}, []
    for run, batch in RUNS:
        runs[run] = eng.run_debug(lanes[batch])
        call = eng.debug_call_for(WITHDRAW_WIDTH)
        states.append((call.warm, call.outputs is not None, call.replays))
    jeng = JaxWithdrawEngine(WITHDRAW_LEVELS)
    want = {k: jeng.run_debug(v) for k, v in lanes.items()}
    return eng, runs, states, want, lanes


@pytest.mark.parametrize("run,batch", RUNS)
def test_run_debug_equals_jax(withdraw_runs, run, batch):
    (h, ok, dbg), (jh, jok, jdbg) = withdraw_runs[1][run], \
        withdraw_runs[3][batch]
    assert h == jh and all(type(v) is int for v in h)
    assert isinstance(ok, np.ndarray) and ok.dtype == np.bool_
    assert ok.tolist() == np.asarray(jok).tolist()
    assert ok.tolist().count(False) == 1
    assert sorted(dbg) == sorted(jdbg) == ["state_hash"]
    assert_same(convert.debug_to_numpy(dbg), jdbg, "dbg")


def test_run_debug_captures_its_own_width(withdraw_runs):
    eng, runs, states = withdraw_runs[:3]
    assert states == STATES
    assert sorted(eng.debug_calls) == [WITHDRAW_WIDTH] and not eng.calls
    call = eng.debug_calls[WITHDRAW_WIDTH]
    assert call.shapes == aot.withdraw_input_shapes(WITHDRAW_LEVELS,
                                                    WITHDRAW_WIDTH)
    assert call.pool is eng._pool and eng.debug_call_for(WITHDRAW_WIDTH) \
        is call
    a1, a2 = runs["A1"][2]["state_hash"], runs["A2"][2]["state_hash"]
    assert torch.equal(a1, a2) and a1.data_ptr() != a2.data_ptr()
    assert a1.data_ptr() != call.outputs[2]["state_hash"].data_ptr()


# ---------------------------------------------------------------------------
# Capture-safety mirror
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["full_debug", "withdraw_debug"])
def test_capture_safety_mirror(monkeypatch, request, inputs, path):
    """A call of the route records no op that a CUDA-graph capture refuses
    (`torch_capture.REFUSED`). The route's engine has run it three times
    already, so every table and constant is built: the call is the one a
    card would capture."""
    if path == "full_debug":
        eng = request.getfixturevalue("rollup_runs")[0]
        call, packed = eng.debug_call, eng.pack(inputs["A"])
    else:
        eng, lanes = request.getfixturevalue("withdraw_runs")[::4]
        call = eng.debug_call_for(WITHDRAW_WIDTH)
        packed = eng.pack(lanes["A"])
    rec = record_ops(monkeypatch, lambda: call(packed))
    print(f"{path}: {rec.count} aten ops a call outside the plain versions "
          "of the kernels")
    assert rec.count > 1000
    assert not rec.refused, sorted(rec.refused.items())


# ---------------------------------------------------------------------------
# CapturedCall's trees
# ---------------------------------------------------------------------------

SHAPES = {"x": ((16, 3), torch.int64)}


def _batch(i):
    return {"x": torch.full((16, 3), i, dtype=torch.int64)}


def test_captured_call_passes_leaves_that_are_no_tensors():
    call = aot.CapturedCall(
        lambda d: {"y": d["x"] + 1, "n": 3, "name": "key1", "none": None,
                   "pair": [d["x"] * 2, (7, None)]}, SHAPES, "cpu")
    outs = [call(_batch(i)) for i in (1, 2, 1, 5)]  # eager, capture, replays
    assert call.replays == 2
    for i, out in zip((1, 2, 1, 5), outs):
        assert (out["n"], out["name"], out["none"]) == (3, "key1", None)
        assert out["pair"][1] == (7, None) and isinstance(out["pair"], list)
        assert torch.equal(out["y"], _batch(i + 1)["x"])
        assert torch.equal(out["pair"][0], _batch(2 * i)["x"])


def test_captured_call_refuses_a_host_value_that_moves():
    """A leaf read from the data is fixed at the capture, as a graph would
    fix it; the CPU's replay says so instead of returning it stale."""
    call = aot.CapturedCall(lambda d: (d["x"] + 1, int(d["x"][0, 0])),
                            SHAPES, "cpu")
    assert call(_batch(1))[1] == 1 and call(_batch(2))[1] == 2
    assert call(_batch(2))[1] == 2
    with pytest.raises(RuntimeError, match="depends on the data"):
        call(_batch(3))


def test_captured_call_clones_aliased_and_passed_through_leaves():
    """One tensor twice, a view of it, and a static input passed through:
    every returned leaf is a clone of its own, right after later batches
    were loaded."""
    def fn(d):
        y = d["x"] * 2
        return {"same": y, "again": y, "view": y[:, :1], "input": d["x"],
                "nested": {"input": d["x"]}}

    call = aot.CapturedCall(fn, SHAPES, "cpu")
    outs = [(i, call(_batch(i))) for i in (1, 2, 1, 3)]
    static = {t.untyped_storage().data_ptr() for t in
              list(_leaves(call.outputs)) + [call.inputs["x"]]}
    seen = set()
    for i, out in outs:
        want = _batch(i)["x"]
        assert torch.equal(out["same"], 2 * want)
        assert torch.equal(out["again"], 2 * want)
        assert torch.equal(out["view"], 2 * want[:, :1])
        assert torch.equal(out["input"], want)
        assert torch.equal(out["nested"]["input"], want)
        ptrs = [t.untyped_storage().data_ptr() for t in _leaves(out)]
        assert len(set(ptrs)) == len(ptrs) == 5
        assert not set(ptrs) & (static | seen)
        seen |= set(ptrs)
