"""The port's witness-vector export on the CPU against the JAX package's,
at the suite's config (3, 16, 2, 2): the name lists, the exported vectors
of a deposit batch and of an L2 + exit batch, the `.wtns` container and the
name sidecar byte for byte, the container's round trip, and the port's copy
of the pure-Python checker, which must accept the port's vectors and refuse
each tampered one; then the same for a batch of Withdraw lanes. Exact."""

import random

import pytest

from circuits_tpu.engine import witness_vector as jwv
from circuits_tpu.engine.witness import (RollupEngine as JaxEngine,
                                         WithdrawEngine as JaxWithdrawEngine)
from circuits_tpu.r1cs import witness_check as j_witness_check
from circuits_tpu_torch.engine import witness_vector as wv
from circuits_tpu_torch.engine.witness import RollupEngine, WithdrawEngine
from circuits_tpu_torch.field.scalar import P
from circuits_tpu_torch.r1cs.witness_check import (verify_withdraw_witness,
                                                   verify_witness)
from circuits_tpu_torch.scripts import withdraw_cases

from torch_compare import SUITE_CONFIG, suite_batches

BATCHES = ["deposit", "l2"]
WD_NLEVELS, WD_LANES = 8, 4


@pytest.fixture(scope="module")
def exported():
    """{batch: ((names, values) of the port, (names, values) of JAX)}."""
    eng = RollupEngine(*SUITE_CONFIG, device="cpu")
    jeng = JaxEngine(*SUITE_CONFIG)
    return {k: (wv.export_witness(eng, bb.get_input()),
                jwv.export_witness(jeng, bb.get_input()))
            for k, bb in suite_batches().items()}


@pytest.mark.parametrize("params", [SUITE_CONFIG, (1, 8, 1, 1), (4, 32, 2, 3),
                                    (16, 32, 8, 4)])
def test_signal_names_match_jax(params):
    names = wv.signal_names(*params)
    assert names == jwv.signal_names(*params)
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("shape", [(16, 1), (8, 5), (32, 3)])
def test_signal_names_withdraw_match_jax(shape):
    assert wv.signal_names_withdraw(*shape) == \
        jwv.signal_names_withdraw(*shape)


@pytest.mark.parametrize("which", BATCHES)
def test_export_matches_jax(exported, which):
    (names, values), (jnames, jvalues) = exported[which]
    assert names == jnames == wv.signal_names(*SUITE_CONFIG)
    assert values == jvalues
    assert values[0] == 1


@pytest.mark.parametrize("which", BATCHES)
def test_values_are_python_ints_below_2_256(exported, which):
    values = exported[which][0][1]
    assert all(type(v) is int for v in values)
    assert all(0 <= v < (1 << 256) for v in values)


@pytest.mark.parametrize("which", BATCHES)
def test_wtns_and_sidecar_bytes_are_jax_s(tmp_path, exported, which):
    (names, values), (jnames, jvalues) = exported[which]
    wv.write_wtns(tmp_path / "t.wtns", values)
    wv.write_sym(tmp_path / "t.sym", names)
    jwv.write_wtns(tmp_path / "j.wtns", jvalues)
    jwv.write_sym(tmp_path / "j.sym", jnames)
    raw = (tmp_path / "t.wtns").read_bytes()
    assert raw == (tmp_path / "j.wtns").read_bytes()
    assert raw[:4] == b"wtns" and len(raw) == 12 + 12 + 40 + 12 + 32 * len(values)
    assert (tmp_path / "t.sym").read_bytes() == \
        (tmp_path / "j.sym").read_bytes()


def test_wtns_round_trip_through_either_reader(tmp_path, exported):
    names, values = exported["l2"][0]
    wv.write_wtns(tmp_path / "w.wtns", values)
    wv.write_sym(tmp_path / "w.sym", names)
    assert wv.read_wtns(tmp_path / "w.wtns") == values
    assert jwv.read_wtns(tmp_path / "w.wtns") == values
    loaded = wv.load_witness(tmp_path / "w.wtns", tmp_path / "w.sym")
    assert loaded == dict(zip(names, values))
    assert loaded == jwv.load_witness(tmp_path / "w.wtns", tmp_path / "w.sym")


@pytest.mark.parametrize("which", BATCHES)
def test_output_matches_builder(exported, which):
    names, values = exported[which][0]
    w = dict(zip(names, values))
    bb = suite_batches()[which]
    assert w["main.hashGlobalInputs"] == bb.get_hash_inputs()
    assert w["main.newStateRoot"] == bb.get_new_state_root()
    assert w["main.newExitRoot"] == bb.get_new_exit_root()


@pytest.mark.parametrize("which", BATCHES)
def test_verify_witness_accepts_the_ports_vector(exported, which):
    names, values = exported[which][0]
    res = verify_witness(dict(zip(names, values)), *SUITE_CONFIG)
    assert res["ok"], f"failures: {res['failures'][:10]}"
    assert res["n_checked"] > 1000
    assert res == j_witness_check.verify_witness(dict(zip(names, values)),
                                                 *SUITE_CONFIG)


# the tampers of tests/test_witness_vector.py::test_tamper_detected, and two
# more: an output root and a decoded amount
TAMPERS = {
    "state hash": ("main.Tx[0].newStHash1", lambda v: (v + 1) % (2 ** 254)),
    "input balance": ("main.balance1[0]", lambda v: v + 1),
    "output root": ("main.newStateRoot", lambda v: (v + 1) % P),
    "decoded amount": ("main.Decoder[0].amount", lambda v: v + 1),
}


@pytest.mark.parametrize("tamper", sorted(TAMPERS))
def test_verify_witness_refuses_a_tampered_vector(exported, tamper):
    names, values = exported["l2"][0]
    w = dict(zip(names, values))
    name, change = TAMPERS[tamper]
    w[name] = change(w[name])
    res = verify_witness(w, *SUITE_CONFIG)
    assert not res["ok"] and res["failures"]
    # the copy says what the original says, failure for failure
    assert res == j_witness_check.verify_witness(w, *SUITE_CONFIG)


# ---------------------------------------------------------------------------
# Withdraw
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported_withdraw():
    lanes = withdraw_cases.exit_tree_batch(random.Random(11), WD_LANES,
                                           WD_NLEVELS)
    lanes = [dict(d, ethAddr=int(str(d["ethAddr"]), 0)) for d in lanes]
    got = wv.export_witness_withdraw(
        WithdrawEngine(WD_NLEVELS, device="cpu"), lanes)
    want = jwv.export_witness_withdraw(JaxWithdrawEngine(WD_NLEVELS), lanes)
    return lanes, got, want


def test_export_withdraw_matches_jax(exported_withdraw):
    _, (names, values), (jnames, jvalues) = exported_withdraw
    assert names == jnames == wv.signal_names_withdraw(WD_NLEVELS, WD_LANES)
    assert values == jvalues
    assert all(type(v) is int for v in values)


def test_export_withdraw_refuses_an_invalid_lane(exported_withdraw):
    lanes = exported_withdraw[0]
    bad = [withdraw_cases.tamper(lanes[0], "balance", WD_NLEVELS)]
    with pytest.raises(AssertionError, match="invalid withdraw witness"):
        wv.export_witness_withdraw(WithdrawEngine(WD_NLEVELS, device="cpu"),
                                   bad)


@pytest.mark.parametrize("tamper", [None, "main.balance[0]",
                                    "main.stateHash[0]", "main.idx[1]",
                                    "main.siblingsState[2][0]"])
def test_verify_withdraw_witness(exported_withdraw, tamper):
    names, values = exported_withdraw[1]
    w = dict(zip(names, values))
    if tamper is not None:
        w[tamper] ^= 1
    res = verify_withdraw_witness(w, WD_NLEVELS, WD_LANES)
    assert res["ok"] == (tamper is None), res["failures"][:5]
    assert res == j_witness_check.verify_withdraw_witness(w, WD_NLEVELS,
                                                          WD_LANES)
