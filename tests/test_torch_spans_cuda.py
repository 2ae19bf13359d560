"""The port's spans on the card: each replay of a captured engine records
one `aot.launch` and one `aot.graph` whose device seconds are read once
the call has returned, the pack's copy records the bytes of every tensor it
moved, and nothing is added to the graph (its nodes and kernel counts as
captured, `kernels.launches` untouched by replays). A device interval
still running when the records are read stays pending, and nothing waits
for it. These tests need a CUDA device and skip without one. They import
no JAX, so they also run on a machine that has none:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m gpu tests/test_torch_spans_cuda.py
"""

import random
import time

import pytest
import torch

from circuits_tpu_torch import kernels, spans
from circuits_tpu_torch.engine import aot
from circuits_tpu_torch.engine.witness import RollupEngine, WithdrawEngine
from circuits_tpu_torch.scripts import withdraw_cases

from torch_compare import SUITE_CONFIG, suite_batches

pytestmark = pytest.mark.gpu

CALL = ["aot.graph", "aot.launch", "aot.replay", "witness.pack",
        "witness.pack.h2d", "witness.run", "witness.unpack"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _since(t0: int) -> list[dict]:
    return [r for r in spans.snapshot() if r["start_ns"] >= t0]


def _check_calls(recs: list[dict], route: str, packed: dict, runs: int):
    """Each `run` among `recs`: the records of one call under one call id,
    the replay's launch and graph inside it, the graph's device seconds
    read, the copy's bytes those of `packed`."""
    roots = [r for r in recs if r["name"] == "witness.run"]
    assert len(roots) == runs
    for root in roots:
        calls = [r for r in recs if r["call"] == root["call"]]
        mine = {r["name"]: r for r in calls}
        assert sorted(mine) == CALL
        replay, launch, graph = (mine[k] for k in ("aot.replay",
                                                   "aot.launch", "aot.graph"))
        assert launch["parent"] == graph["parent"] == replay["seq"]
        assert replay["parent"] == root["seq"]
        for r in (replay, launch, graph):
            assert r["attrs"] == {"route": route}
        assert graph["kind"] == "device" and graph["device_s"] > 0
        assert replay["start_ns"] <= graph["start_ns"] <= launch["start_ns"] \
            <= launch["end_ns"] <= graph["end_ns"] <= replay["end_ns"]
        copies = [r for r in calls if r["name"] == "witness.pack.h2d"]
        assert len(copies) == len(packed)
        assert {r["parent"] for r in copies} == {mine["witness.pack"]["seq"]}
        assert sum(r["counters"]["h2d_bytes"] for r in copies) == sum(
            t.nelement() * t.element_size() for t in packed.values())


@pytest.mark.parametrize("lanes", [1, 33])
def test_withdraw_replays_record_their_launch_and_graph(cuda, lanes):
    n_levels = 16
    batch = withdraw_cases.exit_tree_batch(random.Random(lanes),
                                           max(lanes, 2), n_levels)[:lanes]
    engine = WithdrawEngine(n_levels, device=cuda)
    kernels.reset_launches()
    engine.run(batch)  # op by op
    eager = dict(kernels.launches)
    engine.run(batch)  # the capture
    call = engine.calls[lanes]
    assert call.counts == eager
    nodes, counts = call.nodes, dict(call.counts)
    packed = engine.pack(batch)
    kernels.reset_launches()
    t0 = time.perf_counter_ns()
    for _ in range(3):
        hashes, ok = engine.run(batch)
        assert ok.all()
    _check_calls(_since(t0), "withdraw", packed, 3)
    assert call.replays == 4 and len(call._events) == 1
    assert not any(kernels.launches.values()), kernels.launches
    assert aot.graph_kernels(call.graph, cuda) == (nodes, counts)


def test_rollup_replays_record_their_launch_and_graph(cuda):
    engine = RollupEngine(*SUITE_CONFIG, device=cuda)
    bbs = suite_batches()
    a, b = bbs["l2"].get_input(), bbs["deposit"].get_input()
    kernels.reset_launches()
    engine.run(a)  # op by op
    eager = dict(kernels.launches)
    engine.run(b)  # the capture
    call = engine.call
    assert call.counts == eager
    nodes, counts = call.nodes, dict(call.counts)
    packed = engine.pack(a)
    kernels.reset_launches()
    t0 = time.perf_counter_ns()
    for inp in (a, b, a):
        res, ok = engine.run(inp)
        assert ok
    _check_calls(_since(t0), "rollup", packed, 3)
    assert call.replays == 4 and len(call._events) == 1
    assert not any(kernels.launches.values()), kernels.launches
    assert aot.graph_kernels(call.graph, cuda) == (nodes, counts)


def test_device_interval_stays_pending_until_it_completes(cuda):
    """A pair whose end event has not completed reads `device_s` None and
    holds its events; once the stream has passed it the same record reads
    its seconds, and a pair is handed out again only then."""
    pairs = []
    start, end = spans.event_pair(pairs)
    t = time.perf_counter_ns()
    start.record()
    torch.cuda._sleep(500_000_000)  # about a quarter of a second
    end.record()
    spans.device_interval("t.sleep", start, end, t)
    pending = [r for r in spans.snapshot() if r["name"] == "t.sleep"
               and r["start_ns"] == t]
    assert len(pending) == 1 and pending[0]["device_s"] is None
    assert spans.event_pair(pairs) is not pairs[0] and len(pairs) == 2
    torch.cuda.synchronize(cuda)
    done = [r for r in spans.snapshot() if r["name"] == "t.sleep"
            and r["start_ns"] == t]
    assert done[0]["device_s"] > 0.01
    assert spans.event_pair(pairs) is pairs[0]
