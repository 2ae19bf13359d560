"""What the handoff's readers share: a record's value averaged over the
records of the port's spans named `name` inside the timed window, not over
the window's calls (a refused batch has no read and no write record)."""

from __future__ import annotations

from portbench.metrics import port_spans


def mean(run, name: str, value) -> float | None:
    """The mean of `value(record)` over the window's records named `name`;
    None without a record, or where a record has no value."""
    records = port_spans.window_records(run, name)
    if not records:
        return None
    values = [value(r) for r in records]
    if any(v is None for v in values):
        return None
    return sum(values) / len(values)


def seconds(run, name: str) -> float | None:
    """Host seconds a record of the spans named `name`."""
    return mean(run, name, lambda r: (r["end_ns"] - r["start_ns"]) * 1e-9)
