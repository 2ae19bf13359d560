"""The port's spans and counters (`circuits_tpu_torch/spans.py`) on the CPU:
nesting, parents, call ids and self time; the ring's bound and its count
of drops; the records laid on `torch.profiler`'s clock; the spans that
`RollupEngine.run` and `WithdrawEngine.run` record, under one call id;
the two-stage pack against the one-stage pack it replaced; and the one
copy of the pack's staging buffer with its bytes."""

import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from circuits_tpu_torch import spans
from circuits_tpu_torch.engine import aot, witness
from circuits_tpu_torch.engine.witness import (RollupEngine, WithdrawEngine,
                                               pack_rollup_inputs,
                                               pack_withdraw_inputs)
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.scripts import withdraw_cases

from torch_compare import SUITE_CONFIG, one_thread, suite_batches  # noqa: F401

DEVICE_ONLY = {"witness.pack.h2d", "aot.launch", "aot.graph"}


def _since(t0: int) -> list[dict]:
    return [r for r in spans.snapshot() if r["start_ns"] >= t0]


def _busy(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_nesting_parents_call_ids_and_self_time():
    t0 = time.perf_counter_ns()
    with spans.span("t.outer", tag="a") as outer:
        _busy(0.002)
        with spans.span("t.inner"):
            _busy(0.001)
            spans.count("items", 3)
            spans.count("items", 4)
        with spans.span("t.inner"):
            with spans.span("t.leaf"):
                _busy(0.001)
        spans.count("bytes", 10)
    with spans.span("t.outer"):
        pass
    recs = _since(t0)
    assert [r["name"] for r in recs] == ["t.inner", "t.leaf", "t.inner",
                                         "t.outer", "t.outer"]
    inner1, leaf, inner2, first, second = recs
    assert first["seq"] == outer.seq and first["attrs"] == {"tag": "a"}
    assert first["parent"] is None and second["parent"] is None
    assert inner1["parent"] == inner2["parent"] == first["seq"]
    assert leaf["parent"] == inner2["seq"]
    assert {r["call"] for r in recs[:4]} == {first["call"]}
    assert second["call"] != first["call"]
    assert inner1["counters"] == {"items": 7}
    assert first["counters"] == {"bytes": 10} and leaf["counters"] is None
    assert leaf["attrs"] is None
    assert all(r["kind"] == "span" and r["device_s"] is None for r in recs)
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
    for child in (inner1, inner2):
        assert first["start_ns"] <= child["start_ns"] <= child["end_ns"] \
            <= first["end_ns"]

    def dur(r):
        return (r["end_ns"] - r["start_ns"]) * 1e-9
    summary = spans.summary()
    outer_self = dur(first) - dur(inner1) - dur(inner2)
    assert outer_self >= 0.002
    mean_self = (outer_self + dur(second)) / 2
    assert summary["t.outer"]["self_s"] == pytest.approx(mean_self, rel=1e-9)
    assert summary["t.outer"]["count"] >= 2
    assert summary["t.inner"]["items"] >= 7
    with pytest.raises(RuntimeError, match="outside any span"):
        spans.count("items", 1)


def test_ring_keeps_capacity_and_counts_drops():
    spans.clear()
    assert spans.dropped() == 0 and spans.snapshot() == []
    extra = 7
    for i in range(spans.CAPACITY + extra):
        with spans.span("t.ring", i=i):
            pass
    recs = spans.snapshot()
    assert len(recs) == spans.CAPACITY and spans.dropped() == extra
    assert recs[0]["attrs"] == {"i": extra}
    assert recs[-1]["attrs"] == {"i": spans.CAPACITY + extra - 1}
    spans.clear()
    assert spans.dropped() == 0 and spans.snapshot() == []


def test_profiler_ns_lays_a_span_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("t.mm") as rec:
            _busy(0.002)
            torch.mm(a, a)
            _busy(0.002)
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert spans.profiler_ns(rec.start_ns) <= start <= end \
        <= spans.profiler_ns(rec.end_ns)
    # well inside: the offset is no coarser than the busy waits
    assert start - spans.profiler_ns(rec.start_ns) >= 1_000_000
    assert spans.profiler_ns(rec.end_ns) - end >= 1_000_000


def test_threads_keep_their_own_stacks_and_lose_no_record():
    """More threads than cores record nested spans with the interpreter
    switching threads as often as it can: each thread's spans nest inside
    its own roots, and every record put is kept or counted as dropped."""
    spans.clear()
    threads, rounds = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for i in range(rounds):
            with spans.span("t.root", thread=k):
                with spans.span("t.child", thread=k):
                    spans.count("n", 1)
    try:
        pool = [threading.Thread(target=work, args=(k,))
                for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    recs = spans.snapshot()
    assert len(recs) + spans.dropped() == 2 * threads * rounds
    assert spans.dropped() == 0
    roots = {r["seq"]: r for r in recs if r["name"] == "t.root"}
    assert len({r["call"] for r in roots.values()}) == threads * rounds
    for r in recs:
        if r["name"] == "t.child":
            root = roots[r["parent"]]
            assert root["attrs"] == r["attrs"] and root["call"] == r["call"]
            assert r["counters"] == {"n": 1}
    spans.clear()


class _Event:
    """A stand-in for `torch.cuda.Event`: completed once `done` is set."""

    def __init__(self, enable_timing=False):
        self.done = False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return 2.5  # ms


def test_pending_pair_stays_pending_and_is_not_handed_out(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    pairs = []
    start, end = spans.event_pair(pairs)
    assert pairs == [(start, end)]
    t = time.perf_counter_ns()
    with spans.span("t.call") as call:
        spans.device_interval("t.device", start, end, t, route="r")
    recs = [r for r in spans.snapshot() if r["name"] == "t.device"
            and r["start_ns"] == t]
    assert len(recs) == 1 and recs[0]["device_s"] is None
    assert recs[0]["kind"] == "device" and recs[0]["attrs"] == {"route": "r"}
    assert recs[0]["parent"] == call.seq and recs[0]["call"] == call.call
    assert t <= recs[0]["end_ns"] <= call.end_ns
    # pending: a second pair is made, the first is not re-recorded
    other = spans.event_pair(pairs)
    assert other is not pairs[0] and len(pairs) == 2
    end.done = True
    assert spans.event_pair(pairs) is pairs[0]
    recs = [r for r in spans.snapshot() if r["name"] == "t.device"
            and r["start_ns"] == t]
    assert recs[0]["device_s"] == pytest.approx(2.5e-3)
    assert spans.summary()["t.device"]["mean_s"] == pytest.approx(2.5e-3)


def _one_call(recs: list[dict], route: str) -> None:
    """The records of one `run` through a replay: `witness.run` the root of
    the pack, the replay and the unpack, all under its call id; none of the
    records a device other than the CPU makes."""
    runs = [r for r in recs if r["name"] == "witness.run"]
    assert len(runs) == 1
    run = runs[0]
    assert run["parent"] is None
    children = [r for r in recs if r["parent"] == run["seq"]]
    assert [r["name"] for r in children] == ["witness.pack", "aot.replay",
                                             "witness.unpack"]
    assert {r["call"] for r in recs} == {run["call"]}
    assert children[1]["attrs"] == {"route": route}
    assert not {r["name"] for r in recs} & DEVICE_ONLY


def test_rollup_run_records_its_spans_on_the_cpu():
    engine = RollupEngine(*SUITE_CONFIG, device="cpu")
    engine.compile()  # the next run is a replay
    inp = suite_batches()["l2"].get_input()
    t0 = time.perf_counter_ns()
    res, ok = engine.run(inp)
    assert ok and engine.call.replays == 1
    _one_call(_since(t0), "rollup")


def test_withdraw_run_records_its_spans_on_the_cpu():
    lanes = withdraw_cases.exit_tree_batch(random.Random(3), 4, 8)
    engine = WithdrawEngine(8, device="cpu")
    engine.compile(len(lanes))
    t0 = time.perf_counter_ns()
    hashes, ok = engine.run(lanes)
    assert ok.all() and engine.calls[len(lanes)].replays == 1
    _one_call(_since(t0), "withdraw")


def _old_pack_rollup(inp, max_fee_tx):
    """The one-stage pack that the two-stage one replaced, on the CPU."""
    def flags(vals):
        return torch.tensor([int(v) for v in vals], dtype=torch.int64)

    out = {}
    for k in ("oldLastIdx", "oldStateRoot", "globalChainID",
              "currentNumBatch", "imInitStateRootFee"):
        out[k] = fr.pack([inp[k]])
    for k in ("txCompressedData", "amountF", "txCompressedDataV2", "fromIdx",
              "auxFromIdx", "toIdx", "auxToIdx", "toBjjAy", "toEthAddr",
              "maxNumBatch", "rqTxCompressedDataV2", "rqToEthAddr",
              "rqToBjjAy", "s", "r8x", "r8y", "loadAmountF", "fromEthAddr",
              "tokenID1", "nonce1", "balance1", "ay1", "ethAddr1", "oldKey1",
              "oldValue1", "tokenID2", "nonce2", "balance2", "ay2",
              "ethAddr2", "oldKey2", "oldValue2", "feePlanTokens", "feeIdxs",
              "imFinalAccFee", "tokenID3", "nonce3", "balance3", "ay3",
              "ethAddr3"):
        out[k] = fr.pack(inp[k])
    for k in ("onChain", "newAccount", "newExit", "isOld0_1", "isOld0_2",
              "sign1", "sign2", "rqOffset", "sign3"):
        out[k] = flags(inp[k])
    bjj = np.array(inp["fromBjjCompressed"], dtype=np.int64).reshape(-1, 256)
    out["fromBjjCompressed"] = torch.from_numpy(np.ascontiguousarray(bjj.T))
    for k in ("siblings1", "siblings2", "siblings3"):
        out[k] = fr.pack(inp[k]).permute(2, 0, 1).contiguous()
    out["imOnChain"] = flags(inp["imOnChain"])
    for k in ("imOutIdx", "imStateRoot", "imExitRoot", "imStateRootFee"):
        out[k] = fr.pack(inp[k])
    acc = fr.pack(inp["imAccFeeOut"])
    if acc.dim() == 2:
        acc = acc.reshape(16, 0, max_fee_tx)
    out["imAccFeeOut"] = acc.permute(2, 0, 1).contiguous()
    return out


def _same(new: dict, old: list) -> None:
    assert len(new) == len(old)
    for (k, got), want in zip(new.items(), old):
        assert (got.dtype, got.shape) == (want.dtype, want.shape), k
        assert torch.equal(got, want), k
        assert got.is_contiguous(), k


@pytest.mark.parametrize("batch", ["deposit", "l2"])
def test_two_stage_pack_equals_the_old_pack(batch):
    inp = suite_batches()[batch].get_input()
    new = pack_rollup_inputs(inp, *SUITE_CONFIG, device="cpu")
    old = _old_pack_rollup(inp, SUITE_CONFIG[3])
    assert new.keys() == aot.rollup_input_shapes(*SUITE_CONFIG).keys()
    # the old dict's camelCase keys, in the same order as the new ones
    camel = {k.lower().replace("_", ""): k for k in old}
    keys = [camel[k.replace("_", "")] for k in new]
    assert keys == list(old)
    _same(new, [old[k] for k in keys])


def test_two_stage_withdraw_pack_equals_the_old_pack():
    lanes = withdraw_cases.exit_tree_batch(random.Random(4), 5, 8)
    lanes[1] = dict(lanes[1], balance=hex(int(lanes[1]["balance"])))
    new = pack_withdraw_inputs(lanes, 8, device="cpu")

    def value(v):
        return int(str(v), 0) if isinstance(v, str) else int(v)
    old = [fr.pack([value(d[k]) for d in lanes])
           for k in ("rootExit", "ethAddr", "tokenID", "balance", "idx",
                     "ay")]
    old.append(torch.tensor([int(d["sign"]) for d in lanes],
                            dtype=torch.int64))
    rows = [list(d["siblingsState"]) + [0] * (9 - len(d["siblingsState"]))
            for d in lanes]
    old.append(fr.pack(rows).permute(2, 0, 1).contiguous())
    assert list(new) == list(aot.withdraw_input_shapes(8, 5))
    _same(new, old)


# the packed keys that are flags or bits: int64 words in the staging
# buffer, 8 bytes a number; every other key is a limb table, staged as
# uint16 limbs, 2 bytes a limb of its packed shape
ROLLUP_WORDS = {"on_chain", "new_account", "new_exit", "is_old0_1",
                "is_old0_2", "sign1", "sign2", "rq_offset", "sign3",
                "from_bjj_compressed", "im_on_chain"}
WITHDRAW_WORDS = {"sign"}


def _staged_bytes(shapes: dict, words: set) -> int:
    return sum((8 if k in words else 2) * int(np.prod(s))
               for k, (s, _) in shapes.items())


def test_copy_stage_counts_its_bytes_off_the_cpu():
    """On a device other than the CPU (here `meta`, which holds no data) the
    pack copies its one staging buffer in one `witness.pack.h2d` inside
    `witness.pack`, with the buffer's bytes: the raw uint16 limbs of every
    limb table and the int64 flags and bits, not the packed int64
    tensors."""
    inp = suite_batches()["l2"].get_input()
    t0 = time.perf_counter_ns()
    packed = pack_rollup_inputs(inp, *SUITE_CONFIG, device="meta")
    copy, pack = _since(t0)
    assert pack["name"] == "witness.pack"
    assert copy["name"] == "witness.pack.h2d"
    assert copy["parent"] == pack["seq"]
    shapes = aot.rollup_input_shapes(*SUITE_CONFIG)
    assert copy["counters"] == {
        "h2d_bytes": _staged_bytes(shapes, ROLLUP_WORDS)}
    assert {k: (tuple(v.shape), v.dtype) for k, v in packed.items()} == \
        shapes


def test_copied_bytes_at_the_production_shapes():
    """The bytes a pack copies at RollupMain(2048, 32, 256, 64) and at
    32,768 Withdraw(32) lanes, from the packed shapes (int64)."""
    def nbytes(shapes):
        return sum(8 * int(np.prod(s)) for s, _ in shapes.values())
    rollup = aot.rollup_input_shapes(2048, 32, 256, 64)
    assert len(rollup) == 64 and nbytes(rollup) == 47_932_024
    withdraw = aot.withdraw_input_shapes(32, 32768)
    assert len(withdraw) == 8 and nbytes(withdraw) == 163_840_000


def test_staged_bytes_at_the_production_shapes():
    """The bytes a pack stages and copies at RollupMain(2048, 32, 256, 64)
    and at 32,768 Withdraw(32) lanes: 32 a value slot, 8 a flag or bit,
    from the packed shapes and from the pack's own tables."""
    shapes = aot.rollup_input_shapes(2048, 32, 256, 64)
    assert _staged_bytes(shapes, ROLLUP_WORDS) == 15_239_704
    tables = witness._rollup_tables(2048, 32, 256, 64)
    assert {t.key for t in tables} == shapes.keys()
    assert witness.staged_sizes(tables) == (340_545, 542_783)
    shapes = aot.withdraw_input_shapes(32, 32768)
    assert _staged_bytes(shapes, WITHDRAW_WORDS) == 41_156_608
    tables = witness._withdraw_tables(32, 32768)
    assert [t.key for t in tables] == list(shapes)
    assert witness.staged_sizes(tables) == (1_277_952, 32_768)
