"""The port's spans on the card: each replay of a captured engine records
one `aot.launch` and one `aot.graph` whose device seconds are read once
the call has returned, the pack's copy records the bytes of every tensor it
moved, and nothing is added to the graph (its nodes and kernel counts as
captured, `kernels.launches` untouched by replays). A device interval
still running when the records are read stays pending, and nothing waits
for it. The pack's staging buffer: one copy a call of its pinned bytes,
reused at the same address, the packs on the card equal to the CPU's, no
stale limbs after shorter rows, and no buffer written while its last copy
is still queued. These tests need a CUDA device and skip without one. They import
no JAX, so they also run on a machine that has none:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m gpu tests/test_torch_spans_cuda.py
"""

import random
import time

import pytest
import torch

from circuits_tpu_torch import kernels, spans
from circuits_tpu_torch.engine import aot, witness
from circuits_tpu_torch.engine.witness import (RollupEngine, WithdrawEngine,
                                               pack_rollup_inputs,
                                               pack_withdraw_inputs)
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


def _staged_bytes(tables) -> int:
    slots, words = witness.staged_sizes(tables)
    return 32 * slots + 8 * words


def _check_calls(recs: list[dict], route: str, staged: int, runs: int):
    """Each `run` among `recs`: the records of one call under one call id,
    the replay's launch and graph inside it, the graph's device seconds
    read, one copy of the `staged` bytes inside the pack."""
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
        assert len(copies) == 1
        assert copies[0]["parent"] == mine["witness.pack"]["seq"]
        assert copies[0]["counters"] == {"h2d_bytes": staged}


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
    kernels.reset_launches()
    t0 = time.perf_counter_ns()
    for _ in range(3):
        hashes, ok = engine.run(batch)
        assert ok.all()
    _check_calls(_since(t0), "withdraw", _staged_bytes(
        witness._withdraw_tables(n_levels, lanes)), 3)
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
    kernels.reset_launches()
    t0 = time.perf_counter_ns()
    for inp in (a, b, a):
        res, ok = engine.run(inp)
        assert ok
    _check_calls(_since(t0), "rollup", _staged_bytes(
        witness._rollup_tables(*SUITE_CONFIG)), 3)
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


def _same_pack(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.is_contiguous(), k
        assert torch.equal(g.cpu(), w), k


def _withdraw_lanes(n: int, n_levels: int = 16, seed: int = 5) -> list:
    return withdraw_cases.exit_tree_batch(random.Random(seed), n, n_levels)


def test_staged_pack_on_the_card_equals_the_cpu_pack(cuda):
    bbs = suite_batches()
    for name in ("l2", "deposit"):
        inp = bbs[name].get_input()
        _same_pack(pack_rollup_inputs(inp, *SUITE_CONFIG, device=cuda),
                   pack_rollup_inputs(inp, *SUITE_CONFIG, device="cpu"))
    lanes = _withdraw_lanes(5)
    _same_pack(pack_withdraw_inputs(lanes, 16, device=cuda),
               pack_withdraw_inputs(lanes, 16, device="cpu"))


def test_staging_buffer_is_pinned_and_reused(cuda):
    """A shape's staging buffer is page-locked, made once, and the second
    pack of the shape fills the same memory."""
    lanes = _withdraw_lanes(7)
    nbytes = _staged_bytes(witness._withdraw_tables(16, 7))
    pack_withdraw_inputs(lanes, 16, device=cuda)
    stage = witness.staging(cuda, nbytes)
    made, ptr = len(witness._STAGING), stage.host.data_ptr()
    assert stage.host.is_pinned() and stage.host.numel() == nbytes
    pack_withdraw_inputs(lanes[::-1], 16, device=cuda)
    assert witness.staging(cuda, nbytes) is stage
    assert stage.host.data_ptr() == ptr and len(witness._STAGING) == made


def test_shorter_rows_after_longer_leave_no_stale_limbs(cuda):
    """Sibling rows cut to one value after full rows of the same shape:
    the padding of the second pack is zero, not the first pack's limbs."""
    lanes = _withdraw_lanes(6)
    assert all(len(d["siblingsState"]) > 1 for d in lanes)
    short = [dict(d, siblingsState=d["siblingsState"][:1]) for d in lanes]
    pack_withdraw_inputs(lanes, 16, device=cuda)
    got = pack_withdraw_inputs(short, 16, device=cuda)
    _same_pack(got, pack_withdraw_inputs(short, 16, device="cpu"))
    assert not got["siblings_state"][1:].any()


def test_packs_in_a_row_each_get_their_own_inputs(cuda):
    """Two packs of one shape with different inputs, the first copy held
    back on the stream behind a long sleep: the second pack waits on the
    first copy's event before it writes the buffer, so each gives its own
    answer."""
    a, b = _withdraw_lanes(8, seed=11), _withdraw_lanes(8, seed=12)
    want_a = pack_withdraw_inputs(a, 16, device="cpu")
    want_b = pack_withdraw_inputs(b, 16, device="cpu")
    pack_withdraw_inputs(a, 16, device=cuda)  # the buffer of the shape
    torch.cuda.synchronize(cuda)
    torch.cuda._sleep(200_000_000)  # about a tenth of a second
    got_a = pack_withdraw_inputs(a, 16, device=cuda)
    got_b = pack_withdraw_inputs(b, 16, device=cuda)
    _same_pack(got_a, want_a)
    _same_pack(got_b, want_b)
