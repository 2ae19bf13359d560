"""The port's signal trace on the CPU against the JAX engine's, at the
suite's config (3, 16, 2, 2): the `SIGNALS` catalog letter for letter,
every name through `trace` and through `get_signal` with and without a
lane index, the unknown-name `KeyError`, `_full_debug` against JAX's and
against `run`, and a flag signal of a 16-lane batch, where a flag array
and a limb array both have 16 rows. Exact."""

import pytest
import torch

from circuits_tpu.engine.witness import RollupEngine as JaxEngine
from circuits_tpu_torch import convert
from circuits_tpu_torch.builder import float40
from circuits_tpu_torch.builder.account import HermezAccount
from circuits_tpu_torch.builder.rollup_db import RollupDB
from circuits_tpu_torch.engine.witness import RollupEngine

from torch_compare import SUITE_CONFIG, assert_same, suite_batches

NAMES = sorted(JaxEngine.SIGNALS)


@pytest.fixture(scope="module")
def inp():
    return suite_batches()["l2"].get_input()


@pytest.fixture(scope="module")
def engines():
    return (RollupEngine(*SUITE_CONFIG, device="cpu"),
            JaxEngine(*SUITE_CONFIG))


@pytest.fixture(scope="module")
def traces(engines, inp):
    eng, jeng = engines
    return eng.trace(inp), jeng.trace(inp)


@pytest.fixture(scope="module")
def cached_engine(inp):
    """A port engine whose lane evaluation is done once: `get_signal`
    evaluates the lanes anew at every call, which takes seconds on the CPU;
    what the cases below hold is the lookup, the conversion and the lane
    index."""
    eng = RollupEngine(*SUITE_CONFIG, device="cpu")
    lanes = eng._trace_lanes(inp)
    eng._trace_lanes = lambda _inp: lanes
    return eng


def test_signals_catalog_is_the_jax_catalog():
    assert RollupEngine.SIGNALS == JaxEngine.SIGNALS
    assert list(RollupEngine.SIGNALS) == list(JaxEngine.SIGNALS)
    assert len(RollupEngine.SIGNALS) == 37


@pytest.mark.parametrize("name", NAMES + ["lane_ok", "accFeeOut"])
def test_trace_matches_jax(traces, name):
    got, want = traces
    assert got[name] == want[name]
    flat = got[name] if name != "accFeeOut" else sum(got[name], [])
    assert all(type(v) in (int, bool) for v in flat)


def test_trace_has_the_jax_keys(traces):
    got, want = traces
    assert list(got) == list(want)
    assert got["lane_ok"] == [True] * SUITE_CONFIG[0]


@pytest.mark.parametrize("name", NAMES)
def test_get_signal_matches_jax(cached_engine, engines, inp, name):
    jeng = engines[1]
    assert cached_engine.get_signal(inp, name) == jeng.get_signal(inp, name)
    for lane in (0, 2):
        assert cached_engine.get_signal(inp, f"{name}[{lane}]") == \
            jeng.get_signal(inp, f"{name}[{lane}]")


def test_get_signal_evaluates_the_lanes(engines, inp):
    eng, jeng = engines
    assert eng.get_signal(inp, "states.key1[1]") == 257 == \
        jeng.get_signal(inp, "states.key1[1]")


@pytest.mark.parametrize("name", ["not.a.signal", "states.key9[1]", "[1]"])
def test_get_signal_unknown_name(engines, inp, name):
    eng, jeng = engines
    with pytest.raises(KeyError) as got:
        eng.get_signal(inp, name)
    with pytest.raises(KeyError) as want:
        jeng.get_signal(inp, name)
    assert got.value.args == want.value.args
    assert str(sorted(eng.SIGNALS)) in got.value.args[0]


@pytest.fixture(scope="module")
def full_debug(engines, inp):
    eng, jeng = engines
    return eng._full_debug(inp), jeng._full_debug(inp)


@pytest.mark.parametrize("part", ["lanes", "lane_ok", "outputs", "ok"])
def test_full_debug_matches_jax(full_debug, part):
    got, want = full_debug
    i = ["lanes", "lane_ok", "outputs", "ok"].index(part)
    assert_same(convert.debug_to_numpy(got[i]), want[i], part)
    if isinstance(want[i], dict):
        assert sorted(got[i]) == sorted(want[i])


def test_full_debug_gives_runs_outputs(full_debug, engines, inp):
    eng = engines[0]
    _, _, out, ok = full_debug[0]
    want_out, want_ok = eng.run(inp)
    assert eng.unpack_outputs(out) == want_out
    assert bool(ok) == want_ok is True
    assert sorted(out["fee"]) == ["new_balance", "new_root", "new_state_hash",
                                  "old_state_hash"]


# ---------------------------------------------------------------------------
# 16 tx lanes: a flag signal is (16,), a field signal (16, 16)
# ---------------------------------------------------------------------------

CONFIG16 = (16, 16, 4, 2)


@pytest.fixture(scope="module")
def trace16():
    accs = [HermezAccount(i + 1) for i in range(4)]
    db = RollupDB()
    dep = db.build_batch(*CONFIG16)
    for acc in accs:
        dep.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(10_000),
                        tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                        fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))
    dep.build()
    db.consolidate(dep)
    bb = db.build_batch(*CONFIG16)
    for i, acc in enumerate(accs):
        tx = dict(fromIdx=256 + i, toIdx=256 + (i + 1) % 4, tokenID=1,
                  amount=100 + i, userFee=0, nonce=0, onChain=0)
        acc.sign_tx(tx)
        bb.add_tx(tx)
    bb.build()
    inp = bb.get_input()
    eng = RollupEngine(*CONFIG16, device="cpu")
    lanes = eng._trace_lanes(inp)
    eng._trace_lanes = lambda _inp: lanes
    return eng, inp, eng.trace(inp)


def test_flag_signal_of_16_lanes_is_16_flags(trace16):
    _, _, tr = trace16
    assert tr["lane_ok"] == [True] * 16
    assert tr["states.verifySignEnabled"] == [1] * 4 + [0] * 12
    assert tr["states.P1_fnc1"] == [1] * 4 + [0] * 12
    assert tr["states.isExit"] == [0] * 16
    assert tr["isAmountNullified"] == [0] * 16


def test_field_signal_of_16_lanes_is_16_values(trace16):
    eng, inp, tr = trace16
    assert tr["decode.fromIdx"] == [int(v) for v in inp["fromIdx"]]
    assert tr["decode.amount"] == [100, 101, 102, 103] + [0] * 12
    assert tr["states.key1"][:4] == [256, 257, 258, 259]
    assert len(tr["accFeeOut"]) == 2 and len(tr["accFeeOut"][0]) == 16
    assert eng.get_signal(inp, "states.verifySignEnabled[3]") == 1
    assert eng.get_signal(inp, "states.verifySignEnabled[4]") == 0


@pytest.mark.parametrize("dtype", [torch.int64, torch.bool])
def test_to_host_tells_flags_from_limbs_by_axes(dtype):
    flags = torch.tensor([1, 0] * 8).to(dtype)  # (16,): 16 lanes' flags
    assert RollupEngine._to_host(flags) == [1, 0] * 8
    limbs = torch.zeros((16, 16), dtype=torch.int64)
    limbs[0] = torch.arange(16)
    limbs[1, 5] = 1
    want = list(range(16))
    want[5] += 1 << 16
    assert RollupEngine._to_host(limbs) == want
