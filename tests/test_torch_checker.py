"""The port's `check_batch` on the CPU against the JAX package's, at the
suite's config (3, 16, 2, 2): a valid batch, a tampered tx lane and a
tampered fee slot give the same per-lane and per-slot masks, and the masks
name the lane and the slot that were tampered. Exact."""

import numpy as np
import pytest

from circuits_tpu.engine.witness import pack_rollup_inputs as j_pack
from circuits_tpu.r1cs.checker import check_batch as j_check_batch
from circuits_tpu_torch.engine.witness import pack_rollup_inputs
from circuits_tpu_torch.r1cs.checker import check_batch

from torch_compare import SUITE_CONFIG, suite_batches

# case -> (input key, index, change, lanes refused, fee slots refused)
CASES = {
    "valid": (None, None, 0, [], []),
    # the sender's balance no longer matches its leaf
    "tampered lane": ("balance1", 1, 7, [1], []),
    # the fee recipient's leaf no longer matches the fee tree's root
    "tampered fee slot": ("balance3", 0, 1, [], [0]),
}


@pytest.fixture(scope="module")
def checked():
    base = suite_batches()["l2"].get_input()
    res = {}
    for case, (key, i, delta, _, _) in CASES.items():
        inp = dict(base)
        if key is not None:
            inp[key] = list(base[key])
            inp[key][i] += delta
        res[case] = (
            check_batch(pack_rollup_inputs(inp, *SUITE_CONFIG, device="cpu"),
                        *SUITE_CONFIG),
            j_check_batch(j_pack(inp, *SUITE_CONFIG), *SUITE_CONFIG))
    return res


@pytest.mark.parametrize("mask", ["lane_ok", "fee_ok"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_check_batch_matches_jax(checked, case, mask):
    got, want = checked[case]
    assert isinstance(got[mask], np.ndarray) and got[mask].dtype == np.bool_
    assert got[mask].shape == want[mask].shape
    assert got[mask].tolist() == want[mask].tolist()
    assert got["ok"] is want["ok"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_batch_names_what_was_tampered(checked, case):
    got = checked[case][0]
    _, _, _, lanes, slots = CASES[case]
    assert np.flatnonzero(~got["lane_ok"]).tolist() == lanes
    assert np.flatnonzero(~got["fee_ok"]).tolist() == slots
    assert got["ok"] == (not lanes and not slots)
    assert sorted(got) == ["fee_ok", "lane_ok", "ok"]
