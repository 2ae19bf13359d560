"""The readers of the port's own spans (`metrics/port_spans.py` and the nine
metrics that use it): synthetic records inside and outside a run's timed
window give totals a call of the window's records alone, and None where
there is nothing to read; a traced stand-in run on the CPU, where the
port copies nothing to a device and replays no graph, reports none of
them."""

import sys
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.metrics import port_spans

SEED = 2**31 + 1013
NEW = {"h2d_s.rollup", "h2d_s.withdraw", "h2d_bytes.rollup",
       "h2d_bytes.withdraw", "launch_s.rollup", "launch_s.withdraw1",
       "graph_device_s.rollup", "graph_device_s.withdraw",
       "graph_device_s.withdraw1"}


def rec(name, start_s, end_s, device_s=None, counters=None):
    return dict(name=name, start_ns=int(start_s * 1e9),
                end_ns=int(end_s * 1e9), device_s=device_s,
                counters=counters)


class Registry:
    """A stand-in for the port's registry: `snapshot()` and `dropped()`."""

    def __init__(self, records, dropped=0):
        self.records, self.drops = records, dropped

    def snapshot(self):
        return list(self.records)

    def dropped(self):
        return self.drops


# a window of two calls, from 10 s to 12 s on the perf_counter clock
RUN = SimpleNamespace(calls=[(0, 10.0, 11.0), (1, 11.0, 12.0)])
RECORDS = [
    # the warm-up, before the window
    rec("witness.pack.h2d", 9.0, 9.5, counters={"h2d_bytes": 999}),
    rec("aot.launch", 9.6, 9.7),
    rec("aot.graph", 9.6, 9.8, device_s=5.0),
    # the window's two calls, each copying two arrays
    rec("witness.pack.h2d", 10.1, 10.15, counters={"h2d_bytes": 40}),
    rec("witness.pack.h2d", 10.15, 10.2, counters={"h2d_bytes": 24}),
    rec("aot.launch", 10.5, 10.51),
    rec("aot.graph", 10.49, 10.52, device_s=0.25),
    rec("witness.pack.h2d", 11.1, 11.3, counters={"h2d_bytes": 40}),
    rec("witness.pack.h2d", 11.3, 11.4, counters={"h2d_bytes": 24}),
    rec("aot.launch", 11.5, 11.53),
    rec("aot.graph", 11.49, 11.54, device_s=0.35),
    # the recalled and profiled calls, after it
    rec("witness.pack.h2d", 12.5, 12.9, counters={"h2d_bytes": 999}),
    rec("aot.graph", 12.9, 13.0, device_s=7.0),
]
EXPECTED = {"h2d_s": 0.2, "h2d_bytes": 64, "launch_s": 0.02,
            "graph_device_s": 0.3}


@pytest.fixture
def registry(monkeypatch):
    reg = Registry(RECORDS)
    monkeypatch.setitem(sys.modules, port_spans.REGISTRY, reg)
    return reg


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_totals_the_window_a_call(registry, metric):
    value = harness.reader(harness.ROOT, metric)(RUN)
    assert value == pytest.approx(EXPECTED[metric.split(".")[0]], rel=1e-6)


def test_readers_find_nothing_to_read(registry, monkeypatch):
    assert port_spans.span_seconds(RUN, "witness.pack") is None
    assert port_spans.counter(RUN, "aot.launch", "h2d_bytes") is None
    assert port_spans.span_seconds(SimpleNamespace(calls=[]),
                                   "aot.launch") is None
    # a pair still pending in the window
    registry.records = RECORDS + [rec("aot.graph", 10.6, 10.7)]
    assert port_spans.device_seconds(RUN, "aot.graph") is None
    # the ring dropped records of the window
    registry.records, registry.drops = RECORDS[5:], 3
    assert port_spans.span_seconds(RUN, "aot.launch") is None
    # it dropped older ones only
    registry.records = RECORDS[1:]
    assert port_spans.span_seconds(RUN, "aot.launch") == pytest.approx(0.02)
    # a port without the registry
    monkeypatch.delitem(sys.modules, port_spans.REGISTRY)
    for metric in NEW:
        assert harness.reader(harness.ROOT, metric)(RUN) is None


@pytest.mark.parametrize("cell", ["standin.backlog", "standin.transfers"])
def test_traced_cpu_run_reports_none_of_them(standin_root, cell):
    result, _ = harness.run_cell(standin_root, cell, SEED, 0.01, True,
                                 device="cpu")
    assert result["correct"]
    assert "circuits_tpu_torch.spans" in sys.modules
    assert not set(result["metrics"]) & NEW
    assert result["metrics"], "the run's other metrics are read"
