"""The port's own spans and counters: where a call of the engines spends its
time, kept in the process's memory.

    with spans.span("witness.pack"):          # a host span
        ...
        spans.count("h2d_bytes", n)           # on the innermost open span
    spans.device_interval("aot.graph", start, end, start_ns)

A span records its name, its start and end on `time.perf_counter_ns()`, its
parent (the span it opened inside, by `seq`) and a call id: the outermost
open span of a thread takes a new call id and every span inside it shares
it, so the records of one request can be gathered. Keyword arguments are
kept as the record's `attrs` (None without any). A device interval is a
pair of timing events (`torch.cuda.Event(enable_timing=True)`) recorded
around device work, stamped with the host interval in which the pair was
enqueued; its device
seconds are read later, once the end event has completed (`query()`). A
pair still running when the records are read stays pending (`device_s`
None): nothing here synchronises or waits for the device.

Records go into a ring of `CAPACITY`; once it is full the oldest are
dropped and counted (`dropped()`). `snapshot()` returns the records,
`summary()` their count, mean, median, 95th percentile and mean self time
(a span's duration less its child spans') by name. `profiler_ns` lays a
record's time on the clock of `torch.profiler`'s events, the real-time
clock, so that a record can be set beside a device trace.

The registry is always on. It writes nothing into a profile: no
`record_function` range, no NVTX range.
"""

from __future__ import annotations

import itertools
import statistics
import threading
import time
from collections import defaultdict, deque

import torch

# about 9,000 calls of 14 records each (a one-lane Withdraw call's)
CAPACITY = 1 << 17

_ring: deque = deque(maxlen=CAPACITY)
_written = 0  # records put in the ring since the last clear()
_local = threading.local()
_seqs = itertools.count()
_calls = itertools.count()
_pending: list = []  # device intervals whose end event had not completed
_lock = threading.Lock()  # guards _ring with _written, and _pending

# what `snapshot()` gives of a record; `events` is a pending pair's
_FIELDS = ("seq", "name", "kind", "start_ns", "end_ns", "parent", "call",
           "attrs", "counters", "device_s")


def _stack() -> list:
    """The open spans of this thread, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Record:
    """A span (a context manager) or a device interval."""
    __slots__ = _FIELDS + ("events",)

    def __init__(self, kind: str, name: str, attrs: dict):
        self.kind, self.name, self.attrs = kind, name, attrs or None
        self.counters = self.device_s = self.events = None

    def _place(self, stack: list) -> None:
        """Take a sequence number, and the parent and call id from the
        spans open around the record."""
        self.seq = next(_seqs)
        if stack:
            top = stack[-1]
            self.parent, self.call = top.seq, top.call
        else:
            self.parent, self.call = None, next(_calls)

    def _put(self) -> None:
        global _written
        with _lock:
            _ring.append(self)
            _written += 1

    def __enter__(self):
        stack = _stack()
        self._place(stack)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        self._put()
        return False


def span(name: str, **attrs) -> _Record:
    """A context manager that records a host span named `name`."""
    return _Record("span", name, attrs)


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` of the innermost open span."""
    stack = _stack()
    if not stack:
        raise RuntimeError(f"spans.count({name!r}) outside any span")
    rec = stack[-1]
    if rec.counters is None:
        rec.counters = {}
    rec.counters[name] = rec.counters.get(name, 0) + n


def _settle() -> None:
    """Read the device seconds of every pending pair that has completed."""
    with _lock:
        still = []
        for rec in _pending:
            start, end = rec.events
            if end.query():
                rec.device_s = start.elapsed_time(end) * 1e-3
                rec.events = None
            else:
                still.append(rec)
        _pending[:] = still


def event_pair(pairs: list) -> tuple:
    """A pair of timing events from `pairs`, a list its caller keeps, that
    no pending interval holds; a new pair joins `pairs` when every pair
    there is pending."""
    _settle()
    with _lock:
        held = {id(rec.events[1]) for rec in _pending}
    for pair in pairs:
        if id(pair[1]) not in held:
            return pair
    pair = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    pairs.append(pair)
    return pair


def device_interval(name: str, start_event, end_event, start_ns: int,
                    **attrs) -> None:
    """Record the device time between two events just recorded on a stream,
    `start_ns` (`perf_counter_ns`) taken before the first was recorded."""
    rec = _Record("device", name, attrs)
    rec._place(_stack())
    rec.start_ns, rec.end_ns = start_ns, time.perf_counter_ns()
    rec.events = (start_event, end_event)
    with _lock:
        _pending.append(rec)
    rec._put()


def dropped() -> int:
    """Records the full ring has dropped since the last `clear()`."""
    with _lock:
        return _written - len(_ring)


def clear() -> None:
    """Empty the ring and its count of drops."""
    global _written
    with _lock:
        _ring.clear()
        _written = 0


def snapshot() -> list[dict]:
    """The records in the ring, oldest first, each a dict of `seq`, `name`,
    `kind` ("span" or "device"), `start_ns`, `end_ns`, `parent`, `call`,
    `attrs`, `counters` and `device_s` (a device interval's seconds, None
    while pending or for a span)."""
    _settle()
    with _lock:
        recs = list(_ring)
    return [{k: getattr(r, k) for k in _FIELDS} for r in recs]


def _quantile(values: list, q: int) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def summary() -> dict:
    """{name: count, mean_s, p50_s, p95_s, self_s (mean self seconds) and
    the counters' totals} of the records in the ring. A device interval
    gives its device seconds, and only once they are read."""
    recs = snapshot()
    covered = defaultdict(int)
    for r in recs:
        if r["kind"] == "span" and r["parent"] is not None:
            covered[r["parent"]] += r["end_ns"] - r["start_ns"]
    seconds, selfs = defaultdict(list), defaultdict(list)
    counters = defaultdict(lambda: defaultdict(int))
    for r in recs:
        if r["kind"] == "span":
            d = (r["end_ns"] - r["start_ns"]) * 1e-9
            s = d - covered[r["seq"]] * 1e-9
        elif r["device_s"] is not None:
            d = s = r["device_s"]
        else:
            continue
        seconds[r["name"]].append(d)
        selfs[r["name"]].append(s)
        for k, n in (r["counters"] or {}).items():
            counters[r["name"]][k] += n
    return {name: dict(count=len(v), mean_s=statistics.fmean(v),
                       p50_s=_quantile(v, 50), p95_s=_quantile(v, 95),
                       self_s=statistics.fmean(selfs[name]),
                       **counters[name])
            for name, v in seconds.items()}


def _clock_offset() -> int:
    """`time.time_ns()` less `time.perf_counter_ns()`, from the closest of
    a few paired readings."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


_OFFSET = _clock_offset()


def profiler_ns(t: int) -> int:
    """A record's `perf_counter_ns` time on the clock of `torch.profiler`'s
    events (`time.time_ns()`), by an offset taken once at import."""
    return t + _OFFSET
