"""The comparison that decides `correct`: every call the window completed,
held exactly against the plain reference once the window has closed.

The outputs are integers mod p, so each number compared is a count of
calls (or lanes) whose output differs from the reference's in one
respect, and its limit is 0. `judge` returns the checks as (name, value,
limit) in a fixed order: `calls_missing` first, then the entry's own
(`judge` of `routes/<entry>.py`); a run is correct when each value is at
most its limit.
"""

from __future__ import annotations

from .traffic import answers


def judge(route, load, calls: list):
    """`route`: the entry's module (`routes/<entry>.py`); `calls`: (item,
    output) of every call of the window, in order. Returns (checks, the
    number of calls that differ in any respect)."""
    failed = set()
    answers(load, {item for item, _ in calls})
    checks = route.judge(load, calls, failed)
    return [("calls_missing", 0 if calls else 1, 0)] + checks, len(failed)
