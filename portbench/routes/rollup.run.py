"""`rollup.run`: `RollupEngine.run(inp)`, one RollupMain batch a call,
with its judge and its control.

The judge counts the calls whose lane step's new state root, new exit
root or newLastIdx, fee tail's accFeeOut, SHA tail's hashGlobalInputs, or
verdict ok (False exactly for the batches the traffic gave a bad
signature) differ from the reference's; each limit is 0.
"""

from __future__ import annotations

from portbench.entries import sync, warm
from portbench.reference.scalar import P

FIELDS = ("new_state_root", "new_exit_root", "new_last_idx", "acc_fee_out",
          "hash_global_inputs", "ok")


class Entry:
    """`RollupEngine.run(inp)`: pack, replay, unpack; a call returns
    (outputs dict of host ints, ok)."""

    def __init__(self, config: dict, load, device):
        from circuits_tpu_torch.engine.witness import RollupEngine

        self.load, self.device = load, device
        self.engine = RollupEngine(config["nTx"], config["nLevels"],
                                   config["maxL1Tx"], config["maxFeeTx"],
                                   device=device)
        self.route = self.engine.call

    def warm(self) -> dict:
        return warm(self)

    def call(self, i: int, index: int = 0):
        return self.engine.run(self.load.items[i])

    def call_traced(self, i: int, spans, index: int = 0):
        e = self.engine
        with spans("pack"):
            packed = e.pack(self.load.items[i])
        with spans("replay"):
            out, ok = e.run_packed(packed)
            sync(self.device)
        with spans("unpack"):
            res = e.unpack_outputs(out), bool(ok)
        return res

    @staticmethod
    def canonical(out):
        return out

    def counters(self) -> dict:
        return {"graph_nodes": self.route.nodes}


def _count(wrong: dict, key: str, bad: bool, failed: set, pos: int):
    if bad:
        wrong[key] += 1
        failed.add(pos)


def judge(load, calls, failed):
    """The checks of `calls`, (item, output) in the window's order; adds
    the position of each call that differs to `failed`."""
    wrong = dict.fromkeys(FIELDS, 0)
    for pos, (item, (out, ok)) in enumerate(calls):
        exp = load.expected[item]
        for k in FIELDS[:-1]:
            _count(wrong, k, out.get(k) != exp[k], failed, pos)
        _count(wrong, "ok", ok is not exp["ok"], failed, pos)
    return [(f"calls_wrong_{k}", n, 0) for k, n in wrong.items()]


def control(load, item):
    """The reference's output for `item`, every field element left lazily
    reduced (x + p)."""
    exp = load.expected[item]
    out = {key: (exp[key] + P if key != "acc_fee_out"
                 else [v + P for v in exp[key]])
           for key in FIELDS[:-1]}
    return out, exp["ok"]
