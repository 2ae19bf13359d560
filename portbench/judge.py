"""The comparison that decides `correct`: every call the window completed,
held exactly against the plain reference once the window has closed.

The outputs are integers mod p, so each number compared is a count of
calls (or Withdraw lanes) whose output differs from the reference's in one
respect, and its limit is 0. `judge` returns the checks as (name, value,
limit) in a fixed order; a run is correct when each value is at most its
limit.

RollupMain (`rollup.run`): the lane step's new state root, new exit root
and newLastIdx, the fee tail's accFeeOut, the SHA tail's
hashGlobalInputs, and the verdict ok (False exactly for the batches the
traffic gave a bad signature). Withdraw: every lane's hash (the
reference's SHA-256 of its public fields) and its ok (False exactly for
the claims the traffic altered).
"""

from __future__ import annotations

from .traffic import answers

ROLLUP_FIELDS = ("new_state_root", "new_exit_root", "new_last_idx",
                 "acc_fee_out", "hash_global_inputs", "ok")


def judge(entry: str, load, calls: list):
    """`calls`: (item, output) of every call of the window, in order.
    Returns (checks, the number of calls that differ in any respect)."""
    failed = set()
    answers(load, {item for item, _ in calls})
    if entry == "rollup.run":
        checks = _rollup(load, calls, failed)
    elif entry == "withdraw.run":
        checks = _withdraw(load, calls, failed)
    else:
        raise ValueError(f"unknown entry {entry!r}")
    return [("calls_missing", 0 if calls else 1, 0)] + checks, len(failed)


def _count(wrong: dict, key: str, bad: bool, failed: set, pos: int):
    if bad:
        wrong[key] += 1
        failed.add(pos)


def _rollup(load, calls, failed):
    wrong = dict.fromkeys(ROLLUP_FIELDS, 0)
    for pos, (item, (out, ok)) in enumerate(calls):
        exp = load.expected[item]
        for k in ROLLUP_FIELDS[:-1]:
            _count(wrong, k, out.get(k) != exp[k], failed, pos)
        _count(wrong, "ok", ok is not exp["ok"], failed, pos)
    return [(f"calls_wrong_{k}", n, 0) for k, n in wrong.items()]


def _lanes_wrong(got, exp) -> int:
    """Lanes of one call that differ; every lane where the lengths do."""
    got = list(got)
    if len(got) != len(exp):
        return len(exp)
    return sum(a != b for a, b in zip(got, exp))


def _withdraw(load, calls, failed):
    wrong = dict(hash=0, ok=0)
    for pos, (item, (h, ok)) in enumerate(calls):
        exp = load.expected[item]
        for key, n in (("hash", _lanes_wrong(h, exp["hash"])),
                       ("ok", _lanes_wrong(map(bool, ok), exp["ok"]))):
            wrong[key] += n
            if n:
                failed.add(pos)
    return [(f"lanes_wrong_{k}", n, 0) for k, n in wrong.items()]
