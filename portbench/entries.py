"""The system under test: the port's entry points, as a mix's `entry`
names them. This is the only module of the benchmark that imports the port
(`circuits_tpu_torch`), and it imports nothing else of the repository.

An entry warms up on the load's first items (one call op by op, then the
call that captures the graph: the port's own sequence), and then serves
`call(i)` for the window. `call_traced` is the same call cut at the port's
layers, each piece inside a span: the pack, the replay to its synchronise,
the unpack. It repeats the body of the port's `run` (pack, `run_packed`,
unpack) until the port carries spans of its own, so a traced run holds its
outputs against `call`'s on the same items (`canonical`; the harness's
check `traced_calls_differ`). `counters` reads the port's own counters
once the window has closed.
"""

from __future__ import annotations

import time


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _warm(entry) -> dict:
    """The port's own sequence on the load's first two items: the first
    call of a shape runs op by op, the second captures its graph (index -1:
    no call of the window)."""
    t = time.perf_counter()
    entry.call(0, -1)
    first = time.perf_counter() - t
    t = time.perf_counter()
    entry.call(1 % len(entry.load.items), -1)
    return {"first call": first, "capture call": time.perf_counter() - t,
            **{f"capture.{k}": v for k, v in entry.route.seconds.items()}}


class RollupRun:
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
        return _warm(self)

    def call(self, i: int, index: int = 0):
        return self.engine.run(self.load.items[i])

    def call_traced(self, i: int, spans, index: int = 0):
        e = self.engine
        with spans("pack"):
            packed = e.pack(self.load.items[i])
        with spans("replay"):
            out, ok = e.run_packed(packed)
            _sync(self.device)
        with spans("unpack"):
            res = e.unpack_outputs(out), bool(ok)
        return res

    @staticmethod
    def canonical(out):
        return out

    def counters(self) -> dict:
        return {"graph_nodes": self.route.nodes}


class WithdrawRun:
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
        return _warm(self)

    def call(self, i: int, index: int = 0):
        return self.engine.run(self.load.items[i])

    def call_traced(self, i: int, spans, index: int = 0):
        from circuits_tpu_torch.field import fr

        e = self.engine
        with spans("pack"):
            packed = e.pack(self.load.items[i])
        with spans("replay"):
            h, ok = e.run_packed(packed)
            _sync(self.device)
        with spans("unpack"):
            res = [int(v) for v in fr.unpack_np(h)], fr.to_numpy(ok)
        return res

    @staticmethod
    def canonical(out):
        h, ok = out
        return list(h), [bool(v) for v in ok]

    def counters(self) -> dict:
        return {"graph_nodes": self.route.nodes}


ENTRIES = {"rollup.run": RollupRun, "withdraw.run": WithdrawRun}


def library_seconds() -> float:
    """Load the port's kernel library (built into `build/` of the checkout
    by its first run there) and return the seconds it took."""
    import torch

    if not torch.cuda.is_available():
        return 0.0
    from circuits_tpu_torch import kernels

    t = time.perf_counter()
    kernels.lib()
    return time.perf_counter() - t
