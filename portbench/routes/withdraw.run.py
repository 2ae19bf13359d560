"""`withdraw.run`: `WithdrawEngine.run(lanes)`, a call of Withdraw claims,
with its judge and its control.

The judge counts the lanes whose hash (the reference's SHA-256 of the
lane's public fields) or ok (False exactly for the claims the traffic
altered) differ from the reference's; each limit is 0.
"""

from __future__ import annotations

from portbench.entries import sync, warm
from portbench.reference.scalar import P


class Entry:
    """`WithdrawEngine.run(lanes)`: a call returns (hash list of host ints,
    ok numpy bool array)."""

    def __init__(self, config: dict, load, device):
        from circuits_tpu_torch.engine.witness import WithdrawEngine

        self.load, self.device = load, device
        self.engine = WithdrawEngine(config["nLevels"], device=device)
        self.width = len(load.items[0])

    @property
    def route(self):
        return self.engine.call_for(self.width)

    def warm(self) -> dict:
        return warm(self)

    def call(self, i: int, index: int = 0):
        return self.engine.run(self.load.items[i])

    def call_traced(self, i: int, spans, index: int = 0):
        from circuits_tpu_torch.field import fr

        e = self.engine
        with spans("pack"):
            packed = e.pack(self.load.items[i])
        with spans("replay"):
            h, ok = e.run_packed(packed)
            sync(self.device)
        with spans("unpack"):
            res = [int(v) for v in fr.unpack_np(h)], fr.to_numpy(ok)
        return res

    @staticmethod
    def canonical(out):
        h, ok = out
        return list(h), [bool(v) for v in ok]

    def counters(self) -> dict:
        return {"graph_nodes": self.route.nodes}


def _lanes_wrong(got, exp) -> int:
    """Lanes of one call that differ; every lane where the lengths do."""
    got = list(got)
    if len(got) != len(exp):
        return len(exp)
    return sum(a != b for a, b in zip(got, exp))


def judge(load, calls, failed):
    """The checks of `calls`, (item, output) in the window's order; adds
    the position of each call that differs to `failed`."""
    wrong = dict(hash=0, ok=0)
    for pos, (item, (h, ok)) in enumerate(calls):
        exp = load.expected[item]
        for key, n in (("hash", _lanes_wrong(h, exp["hash"])),
                       ("ok", _lanes_wrong(map(bool, ok), exp["ok"]))):
            wrong[key] += n
            if n:
                failed.add(pos)
    return [(f"lanes_wrong_{k}", n, 0) for k, n in wrong.items()]


def control(load, item):
    """The reference's output for `item`, every hash left lazily reduced
    (x + p)."""
    exp = load.expected[item]
    return [h + P for h in exp["hash"]], exp["ok"]
