"""The port's RollupMain slice, end to end on the CPU (plain versions of
K1-K4), against the JAX package's `RollupEngine` and the builder oracle at
the suite's config (3, 16, 2, 2): public outputs and the verdict, every
`RollupEngine.SIGNALS` path of `rollup_main_lanes(debug=True)` lane by
lane, and a tampered input that flips `ok` in both packages. Exact."""

import pytest

from circuits_tpu.engine.witness import RollupEngine as JaxEngine
from circuits_tpu_torch.engine.witness import RollupEngine
from circuits_tpu_torch.models.rollup_main import (build_chains,
                                                   rollup_main_lanes)

from torch_compare import (SUITE_CONFIG, assert_same, oracle_outputs,
                           suite_batches)

BATCHES = ["deposit", "l2"]


@pytest.fixture(scope="module")
def batches():
    return suite_batches()


@pytest.fixture(scope="module")
def engines():
    return (JaxEngine(*SUITE_CONFIG),
            RollupEngine(*SUITE_CONFIG, device="cpu"))


@pytest.fixture(scope="module")
def runs(batches, engines):
    jeng, teng = engines
    return {k: (teng.run(bb.get_input()), jeng.run(bb.get_input()))
            for k, bb in batches.items()}


@pytest.fixture(scope="module")
def traces(batches, engines):
    """(port lanes, port lane_ok, JAX lanes, JAX lane_ok) per batch."""
    jeng, teng = engines
    n_tx, n_levels, _, max_fee_tx = SUITE_CONFIG
    res = {}
    for k, bb in batches.items():
        inp = bb.get_input()
        packed = teng.pack(inp)
        chains = build_chains(packed, n_tx, max_fee_tx)
        lanes, lane_ok = rollup_main_lanes(packed, chains, n_tx, n_levels,
                                           max_fee_tx, debug=True)
        jlanes, jlane_ok = jeng._trace_lanes(inp)
        res[k] = (lanes, lane_ok, jlanes, jlane_ok)
    return res


@pytest.mark.parametrize("which", BATCHES)
def test_outputs_match_jax_and_builder(batches, runs, which):
    (out, ok), (jout, jok) = runs[which]
    assert ok and jok
    assert out == jout
    want = oracle_outputs(batches[which])
    assert {k: out[k] for k in want} == want


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("name", sorted(JaxEngine.SIGNALS))
@pytest.mark.parametrize("which", BATCHES)
def test_signal_matches_jax(traces, which, name):
    lanes, _, jlanes, _ = traces[which]
    path = JaxEngine.SIGNALS[name][0]
    assert_same(_lookup(lanes, path), _lookup(jlanes, path), name)


@pytest.mark.parametrize("which", BATCHES)
def test_lane_outputs_and_ok_match_jax(traces, which):
    lanes, lane_ok, jlanes, jlane_ok = traces[which]
    assert_same(lane_ok, jlane_ok, "lane_ok")
    assert bool(lane_ok.all())
    for key in ("acc_fee_out", "l1_tx_full_data", "l1l2_tx_data"):
        assert_same(lanes[key], jlanes[key], key)


def test_debug_dict_has_the_jax_keys(traces):
    lanes, _, jlanes, _ = traces["l2"]
    assert sorted(lanes) == sorted(jlanes)
    assert sorted(lanes["tx"]) == sorted(jlanes["tx"])
    assert sorted(lanes["decode"]) == sorted(jlanes["decode"])


def test_tampered_input_fails_in_both(batches, engines):
    jeng, teng = engines
    inp = dict(batches["l2"].get_input())
    inp["balance1"] = list(inp["balance1"])
    inp["balance1"][0] += 7  # the sender's balance no longer matches its leaf
    out, ok = teng.run(inp)
    jout, jok = jeng.run(inp)
    assert not ok and not jok
    assert out == jout
