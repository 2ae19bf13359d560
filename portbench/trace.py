"""Host spans and the device trace of a `--trace 1` run.

Spans are taken by the benchmark around its calls into each of the port's
layers (the pack, the replay to its synchronise, the unpack), kept in memory and read once the run has ended. A short
sub-window of whole calls, after the spans' window, runs under
`torch.profiler`; `reduce_profile` turns its events into the device's busy
seconds, each kernel's device seconds and the idle gaps, each named by the
span the host was in.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch

LABEL = "portbench."


class Spans:
    """Named host spans: `with spans("pack"): ...` adds the seconds to
    `durations["pack"]`; while `labels` is set (under the profiler) each
    span is also a profiler range named `portbench.<name>`."""

    def __init__(self, labels: bool = False):
        self.durations = defaultdict(list)
        self.labels = labels

    @contextmanager
    def __call__(self, name: str):
        label = (torch.profiler.record_function(LABEL + name) if self.labels
                 else nullcontext())
        with label:
            t = time.perf_counter()
            yield
            self.durations[name].append(time.perf_counter() - t)


def _events(prof):
    """(device intervals [(start_ns, end_ns, name)], host ranges of the
    benchmark's labels [(start_ns, end_ns, name)]) of a finished profile."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.name().startswith(LABEL):
            # a label's range; on the device's timeline it is the
            # label's shadow, not an operation
            if e.device_type() != DeviceType.CUDA:
                host.append((start, end, e.name()[len(LABEL):]))
        elif e.device_type() == DeviceType.CUDA:
            device.append((start, end, e.name()))
    return device, host


def reduce_profile(prof, calls: int, gaps: int = 10) -> dict:
    """The profiled sub-window (the `portbench.window` range) read as:
    `window_s`, `busy_s` (the union of the device's operations), `by_name`
    (device seconds by kernel or copy name), `calls`, and the `gaps` longest
    idle gaps as [host span, seconds]."""
    device, host = _events(prof)
    windows = [h for h in host if h[2] == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the profile holds {len(windows)} windows")
    w0, w1, _ = windows[0]
    spans = [h for h in host if h[2] != "window"]
    by_name = defaultdict(float)
    merged = []
    for start, end, name in sorted(device):
        start, end = max(start, w0), min(end, w1)
        if end <= start:
            continue
        by_name[name] += (end - start) * 1e-9
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(e - s for s, e in merged) * 1e-9
    idle, last = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > last:
            mid = (s + last) / 2
            inner = [h for h in spans if h[0] <= mid <= h[1]]
            # the innermost span the host was in, else between calls
            name = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                    else "between calls")
            idle.append([name, (s - last) * 1e-9])
        last = max(last, e)
    idle.sort(key=lambda g: -g[1])
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy, by_name=dict(by_name),
                calls=calls, gaps=idle[:gaps])
