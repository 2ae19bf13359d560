"""Where one batch of withdrawals spends its time on the card.

    python -m circuits_tpu_torch.scripts.withdraw_profile [lanes] [n_levels]

Builds an exit tree of `lanes` random leaves on the host (default 32768,
nLevels 32), packs one withdrawal a leaf, runs
`WithdrawEngine.run_packed_eager` (the eager route, op by op, not the
captured graph) once to warm up (this builds the kernels), times it (median
of 5 synchronised runs), then traces one run with `torch.profiler` and prints the
device's busy time, the number of launches, and the kernels that take most
of it. The profiler slows the host down, so the busy share is given against
both wall times.
"""

from __future__ import annotations

import random
import statistics
import sys
import time

import torch

from ..engine.witness import WithdrawEngine
from . import withdraw_cases
from .exp_mxu_inkernel import card_line

SEED = 20261016


def main(lanes: int = 32768, n_levels: int = 32) -> None:
    engine = WithdrawEngine(n_levels)  # on the card
    batch = withdraw_cases.exit_tree_batch(random.Random(SEED), lanes,
                                           n_levels)
    packed = engine.pack(batch)

    def run():
        h, ok = engine.run_packed_eager(packed)
        h = h.cpu()
        assert bool(ok.all())

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    wall = statistics.median(timed() for _ in range(5))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traced = timed()
    # the kernels themselves: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) * 1e-6
    launches = sum(e.count for e in events)
    print(f"Withdraw({n_levels}) x {lanes} lanes on {card_line()}: "
          f"run_packed_eager median {wall:.4f} s; under the profiler "
          f"{traced:.4f} s; device busy {busy:.4f} s in {launches} launches "
          f"({100 * busy / wall:.1f} % of the untraced time, "
          f"{100 * busy / traced:.1f} % of the traced one)", flush=True)
    if not events:
        raise SystemExit("the profiler recorded no device time")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:10]:
        print(f"  {e.self_device_time_total * 1e-3:9.3f} ms {e.count:6d} x "
              f"{e.key[:90]}", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
