"""The prover's handoff (`witness_vector.handoff`) on the CPU at the suite's
export shape (3, 16, 2, 2) and at RollupMain(4, 16, 2, 2): its file equals
`write_wtns(export_witness(...))` and the JAX package's export written,
byte for byte (also with section IN given as v + p, and with rqOffset
set), a flag or bit of any int64 value is written mod p, a batch the
circuit refuses writes nothing and returns (None, False), `export_witness`
still gives the JAX package's vector (the refused batches too), and its
spans and counters are recorded. Then the benchmark's own checker
(`portbench/reference/witness_check.py`), which imports nothing of the
port: the port's name list, and the port's `verify_witness` failure for
failure on the port's vectors and on the four tampers of
`test_torch_witness_vector.py`, whole and split over lane ranges."""

import os
import sys
import time

import pytest
import torch

from circuits_tpu.engine import witness_vector as jwv
from circuits_tpu.engine.witness import RollupEngine as JaxEngine
from circuits_tpu_torch import spans
from circuits_tpu_torch.engine import witness_vector as wv
from circuits_tpu_torch.engine.witness import RollupEngine, _rollup_tables
from circuits_tpu_torch.field.scalar import P
from circuits_tpu_torch.r1cs.witness_check import verify_witness

from test_torch_witness_vector import TAMPERS
from torch_compare import (RQ_CONFIG, SUITE_CONFIG, one_thread,  # noqa: F401
                           rq_batches, suite_batches)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from portbench.reference import witness_check as ref  # noqa: E402

# each case's shape
CASES = {"suite": SUITE_CONFIG, "rq": RQ_CONFIG}


def _refused_l2(bb) -> dict:
    """The suite's L2 batch with lane 0's EdDSA `s` + 1."""
    inp = bb.get_input()
    return dict(inp, s=[int(inp["s"][0]) + 1] + list(inp["s"][1:]))


@pytest.fixture(scope="module")
def batches():
    """{case: (params, accepted input, refused input)}."""
    rq = rq_batches()
    return {"suite": (SUITE_CONFIG, suite_batches()["l2"].get_input(),
                      _refused_l2(suite_batches()["l2"])),
            "rq": (RQ_CONFIG, rq["past"].get_input(),
                   rq["switched"].get_input())}


@pytest.fixture(scope="module")
def jax_engines():
    return {case: JaxEngine(*params) for case, params in CASES.items()}


@pytest.fixture(scope="module")
def handed(batches, tmp_path_factory):
    """{case: dict(export, accepted, refused, records, ...)}: each case's
    two handoffs and exports on one engine, with the spans each handoff
    recorded."""
    out = {}
    for case, (params, good, bad) in batches.items():
        d = tmp_path_factory.mktemp(case)
        eng = RollupEngine(*params, device="cpu")
        res = dict(params=params, dir=d)
        for kind, inp in (("accepted", good), ("refused", bad)):
            t0 = time.perf_counter_ns()
            res[kind] = wv.handoff(eng, inp, d / f"{kind}.wtns")
            res[kind + "_records"] = [r for r in spans.snapshot()
                                      if r["start_ns"] >= t0]
            res[kind + "_export"] = wv.export_witness(eng, inp)
        out[case] = res
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_handoff_file_is_export_written(handed, case, tmp_path):
    h = handed[case]
    names, values = h["accepted_export"]
    wv.write_wtns(tmp_path / "export.wtns", values)
    got = (h["dir"] / "accepted.wtns").read_bytes()
    assert got == (tmp_path / "export.wtns").read_bytes()
    assert len(got) == 76 + 32 * len(wv.signal_names(*h["params"]))
    out, ok = h["accepted"]
    assert ok is True
    w = dict(zip(names, values))
    F = h["params"][3]
    assert out == dict(
        hash_global_inputs=w["main.hashGlobalInputs"],
        new_state_root=w["main.newStateRoot"],
        new_exit_root=w["main.newExitRoot"],
        new_last_idx=w["main.newLastIdx"],
        acc_fee_out=[w[f"main.accFeeOut[{j}]"] for j in range(F)])


def _plus_p(inp: dict) -> dict:
    """`inp` with every field value of section IN given as v + p (the
    flags and bits, int64 words in the pack, as they are)."""
    fields = {t.src for t in _rollup_tables(1, 1, 1, 1) if t.convert is None}

    def up(v):
        return [up(x) for x in v] if isinstance(v, list) else int(v) + P
    return {k: up(v) if k in fields else v for k, v in inp.items()}


@pytest.fixture(scope="module")
def jax_files(batches, jax_engines, tmp_path_factory):
    """{case: the bytes of `write_wtns` of the JAX package's export of the
    case's accepted batch}."""
    d = tmp_path_factory.mktemp("jax")
    out = {}
    for case, (_, good, _) in batches.items():
        jwv.write_wtns(d / f"{case}.wtns",
                       jwv.export_witness(jax_engines[case], good)[1])
        out[case] = (d / f"{case}.wtns").read_bytes()
    return out


@pytest.mark.parametrize("case,kind", [
    ("suite", "accepted"), ("suite", "plus_p"),
    ("rq", "rq_offset"), ("rq", "plus_p")])
def test_handoff_bytes_equal_the_jax_export(handed, batches, jax_files,
                                           case, kind, tmp_path):
    """The handed-off file, gathered on the device from the debug graph and
    the packed input, equals the JAX package's export written, byte for
    byte: the accepted batch, the same with its section-IN values given as
    v + p, and the rq batch, whose lane 2 has rqOffset 7."""
    params, good, _ = batches[case]
    h = handed[case]
    if kind == "plus_p":
        path = tmp_path / "plus_p.wtns"
        got = wv.handoff(RollupEngine(*params, device="cpu"), _plus_p(good),
                         path)
        assert got == h["accepted"]
    else:
        path = h["dir"] / "accepted.wtns"
    if kind == "rq_offset":
        assert any(int(v) for v in good["rqOffset"])
    assert path.read_bytes() == jax_files[case]


@pytest.mark.parametrize("v", [0, 1, 7, 2**16 - 1, 2**16, 2**63 - 1, -1,
                               -2**63, -wv._P_LO, -wv._P_LO - 1])
def test_words_mod_p(v):
    """A flag or bit word of any int64 value is written as v mod p, as
    `write_wtns` writes it."""
    rows = torch.empty(2, 16, dtype=torch.int16)
    wv._words_mod_p(torch.tensor([v, 1]), rows)
    raw = rows.numpy().tobytes()
    assert raw[:32] == (v % P).to_bytes(32, "little")
    assert raw[32:] == (1).to_bytes(32, "little")


@pytest.mark.parametrize("case", sorted(CASES))
def test_refused_batch_hands_off_nothing(handed, case):
    h = handed[case]
    assert h["refused"] == (None, False)
    assert not (h["dir"] / "refused.wtns").exists()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["accepted", "refused", "plus_p"])
def test_export_witness_unchanged(handed, batches, jax_engines, case,
                                  kind):
    """`export_witness` exports whatever the verdict, the JAX package's
    names and values; with section IN given as v + p, the JAX package's
    values mod P (it returns that section as given)."""
    params, good, bad = batches[case]
    if kind == "plus_p":
        names, values = jwv.export_witness(jax_engines[case], _plus_p(good))
        got = wv.export_witness(RollupEngine(*params, device="cpu"),
                                _plus_p(good))
        assert got == (names, [v % P for v in values])
        assert any(v >= P for v in values)
        return
    inp = good if kind == "accepted" else bad
    assert handed[case][kind + "_export"] == \
        jwv.export_witness(jax_engines[case], inp)


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_and_counters(handed, case):
    h = handed[case]
    recs = h["accepted_records"]
    by = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)
    for name in ("export.handoff", "export.evaluate", "export.read",
                 "export.write"):
        assert len(by[name]) == 1, name
    root = by["export.handoff"][0]
    assert root["parent"] is None
    for name in ("export.evaluate", "export.read", "export.write"):
        assert by[name][0]["parent"] == root["seq"]
        assert by[name][0]["call"] == root["call"]
    # the pack nests inside the evaluation
    pack = by["witness.pack"][0]
    assert pack["parent"] == by["export.evaluate"][0]["seq"]
    size = os.path.getsize(h["dir"] / "accepted.wtns")
    assert by["export.write"][0]["counters"] == {"wtns_bytes": size}
    n = len(wv.signal_names(*h["params"]))
    assert by["export.read"][0]["counters"] == {
        "export_values": n, "export_device_values": n}
    refused = {r["name"] for r in h["refused_records"]}
    assert {"export.handoff", "export.evaluate"} <= refused
    assert not refused & {"export.read", "export.write"}


@pytest.mark.parametrize("params", [SUITE_CONFIG, RQ_CONFIG, (1, 8, 1, 1),
                                    (16, 32, 8, 4), (2048, 32, 256, 64)])
def test_reference_signal_names_are_the_ports(params):
    assert ref.signal_names(*params) == wv.signal_names(*params)


def _split(w, params, parts):
    """The reference's check with its lanes in `parts` ranges."""
    head = ref.verify_head(w, *params)
    failures, n = list(head["failures"]), head["n_checked"]
    carry = None
    for lo, hi in ref.ranges(params[0], parts):
        res = ref.verify_lanes(w, *params, lo, hi)
        failures += res["failures"]
        n += res["n_checked"]
        carry = res["carry"]
    tail = ref.verify_tail(w, *params, carry)
    return dict(ok=not failures + tail["failures"],
                failures=failures + tail["failures"],
                n_checked=n + tail["n_checked"])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tamper", [None] + sorted(TAMPERS))
def test_reference_checker_agrees_with_the_ports(handed, case, tamper,
                                                tmp_path):
    h = handed[case]
    params = h["params"]
    names, values = h["accepted_export"]
    w = dict(zip(names, values))
    if tamper is not None:
        name, change = TAMPERS[tamper]
        w[name] = change(w[name])
    want = verify_witness(w, *params)
    assert want["ok"] is (tamper is None), want["failures"][:5]
    assert ref.verify_witness(w, *params) == want
    for parts in (2, params[0]):
        assert _split(w, params, parts) == want
    path = tmp_path / "w.wtns"
    path.write_bytes(ref.wtns_bytes([w[n] for n in names]))
    assert ref.verify_files({0: path}, params, workers=2)[0] == want


def test_reference_checker_reads_the_handed_off_file(handed):
    h = handed["rq"]
    names = ref.signal_names(*h["params"])
    w = ref.load_vector(h["dir"] / "accepted.wtns", names)
    assert w == dict(zip(*h["accepted_export"]))
    assert ref.load_vector(h["dir"] / "accepted.wtns", names[:-1]) is None
