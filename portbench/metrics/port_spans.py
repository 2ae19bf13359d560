"""What the readers of the port's own spans share: the records of the
port's registry (`circuits_tpu_torch/spans.py`) whose host interval lies
inside a run's timed window, as a total a call.

The registry is reached through `sys.modules`, so that `entries.py` stays
the benchmark's only module that imports the port. A port without the
registry, a window without the record, or a record the registry's ring has
dropped reads None.
"""

from __future__ import annotations

import sys

REGISTRY = "circuits_tpu_torch.spans"


def window_records(run, name: str) -> list[dict] | None:
    """The records named `name` whose host interval lies inside the timed
    window, from the first call's start to the last call's end (the same
    `perf_counter` clock); None where the registry is missing or has
    dropped records of the window."""
    registry = sys.modules.get(REGISTRY)
    if registry is None or not run.calls:
        return None
    t0, t1 = run.calls[0][1] * 1e9, run.calls[-1][2] * 1e9
    records = registry.snapshot()
    if registry.dropped() and (not records or records[0]["end_ns"] >= t0):
        return None
    return [r for r in records if r["name"] == name
            and t0 <= r["start_ns"] and r["end_ns"] <= t1]


def _per_call(run, name: str, value) -> float | None:
    """The total of `value(record)` over the window's records named
    `name`, over the window's calls; None without a record, or where a
    record has no value."""
    records = window_records(run, name)
    if not records:
        return None
    values = [value(r) for r in records]
    if any(v is None for v in values):
        return None
    return sum(values) / len(run.calls)


def span_seconds(run, name: str) -> float | None:
    """Host seconds a call in the spans named `name`."""
    return _per_call(run, name,
                     lambda r: (r["end_ns"] - r["start_ns"]) * 1e-9)


def device_seconds(run, name: str) -> float | None:
    """Device seconds a call in the device intervals named `name`; None
    where one of them is still pending."""
    return _per_call(run, name, lambda r: r["device_s"])


def counter(run, name: str, key: str) -> float | None:
    """The counter `key` of the spans named `name`, a call."""
    return _per_call(run, name, lambda r: (r["counters"] or {}).get(key))
