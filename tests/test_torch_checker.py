"""The port's `check_batch` on the CPU against the JAX package's, at the
suite's config (3, 16, 2, 2): a valid batch, a tampered tx lane, a
tampered fee slot and the valid batch again give the same per-lane and
per-slot masks, and the masks name the lane and the slot that were
tampered. Exact. The four go in that order through one compiled check
(`checker.compiled_check`): the first runs op by op, the second is the
capture (on the CPU a plain call), the last two are replays."""

import numpy as np
import pytest
import torch

from circuits_tpu.engine.witness import pack_rollup_inputs as j_pack
from circuits_tpu.r1cs.checker import check_batch as j_check_batch
from circuits_tpu_torch.engine.aot import rollup_input_shapes
from circuits_tpu_torch.engine.witness import pack_rollup_inputs
from circuits_tpu_torch.r1cs import checker
from circuits_tpu_torch.r1cs.checker import check_batch

from torch_compare import SUITE_CONFIG, suite_batches

# case -> (input key, index, change, lanes refused, fee slots refused)
CASES = {
    "valid": (None, None, 0, [], []),
    # the sender's balance no longer matches its leaf
    "tampered lane": ("balance1", 1, 7, [1], []),
    # the fee recipient's leaf no longer matches the fee tree's root
    "tampered fee slot": ("balance3", 0, 1, [], [0]),
    # the first batch again, through the replay
    "valid again": (None, None, 0, [], []),
}


@pytest.fixture(scope="module")
def checked():
    """{case: (port's result, JAX's result)} and the compiled check's
    (warm, captured, replays) after each case; the check is made fresh,
    since the compiled checks live as long as the process."""
    key = (SUITE_CONFIG, torch.device("cpu"))
    checker._CALLS.pop(key, None)
    base = suite_batches()["l2"].get_input()
    res, states = {}, []
    for case, (key_, i, delta, _, _) in CASES.items():
        inp = dict(base)
        if key_ is not None:
            inp[key_] = list(base[key_])
            inp[key_][i] += delta
        got = check_batch(pack_rollup_inputs(inp, *SUITE_CONFIG,
                                             device="cpu"), *SUITE_CONFIG)
        call = checker._CALLS[key]
        states.append((call.warm, call.outputs is not None, call.replays))
        want = (res["valid"][1] if case == "valid again" else
                j_check_batch(j_pack(inp, *SUITE_CONFIG), *SUITE_CONFIG))
        res[case] = (got, want)
    return res, states


@pytest.mark.parametrize("mask", ["lane_ok", "fee_ok"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_check_batch_matches_jax(checked, case, mask):
    got, want = checked[0][case]
    assert isinstance(got[mask], np.ndarray) and got[mask].dtype == np.bool_
    assert got[mask].shape == want[mask].shape
    assert got[mask].tolist() == want[mask].tolist()
    assert got["ok"] is want["ok"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_batch_names_what_was_tampered(checked, case):
    got = checked[0][case][0]
    _, _, _, lanes, slots = CASES[case]
    assert np.flatnonzero(~got["lane_ok"]).tolist() == lanes
    assert np.flatnonzero(~got["fee_ok"]).tolist() == slots
    assert got["ok"] == (not lanes and not slots)
    assert sorted(got) == ["fee_ok", "lane_ok", "ok"]


def test_check_batch_runs_through_one_compiled_check(checked):
    """Op by op, the capture, two replays; one `CapturedCall` a circuit and
    device, whose device part is `check_masks` at the packed shapes."""
    res, states = checked
    assert states == [(True, False, 0), (True, True, 0), (True, True, 1),
                      (True, True, 2)]
    call = checker.compiled_check(SUITE_CONFIG, "cpu")
    assert call is checker._CALLS[SUITE_CONFIG, torch.device("cpu")]
    assert call.shapes == rollup_input_shapes(*SUITE_CONFIG)
    assert call.pool is None and call.graph is None
    assert checker.compiled_check((4, 16, 2, 2), "cpu") is not call
    first, again = res["valid"][0], res["valid again"][0]
    for mask in ("lane_ok", "fee_ok"):
        assert first[mask].tolist() == again[mask].tolist()
        assert first[mask] is not again[mask]
