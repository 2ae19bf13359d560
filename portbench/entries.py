"""What the port's entry points share. Each entry point, as a mix's `entry`
names it, is a file of its own, `routes/<entry>.py` (found by
`files.load`), holding everything that depends on it:

  Entry          the class the harness drives: built on (config, load,
                 device); `warm()` runs the port's own sequence on the
                 load's first items and returns the seconds of its parts;
                 `call(i)` serves item i in the window; `call_traced(i,
                 spans)` is the same call cut at the port's layers, each
                 piece inside a span (it repeats the body of the port's
                 call, so a traced run holds its outputs against `call`'s
                 on the same items, `canonical`; the harness's check
                 `traced_calls_differ`); `counters()` reads the port's
                 own counters once the window has closed; `route`, the
                 captured call (`CapturedCall`) whose set-up `warm` times
  judge(load, calls, failed)
                 the entry's checks (name, value, limit) on the window's
                 (item, output), after `judge.judge`'s `calls_missing`
  control(load, item)
                 the reference's output for item in the entry's form,
                 with the guarantee broken that `control.py` breaks

The route files and `library_seconds` here are the benchmark's only code
that imports the port (`circuits_tpu_torch`); outside `portbench/` they
import nothing else of the repository.
"""

from __future__ import annotations

import time


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm(entry) -> dict:
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
