"""Run one cell of `BENCHMARK.json` and print its result line.

Everything a cell needs is found by name (`files.py`), under the one
checkout root the run is given: the cell's entry in `BENCHMARK.json`
names its configuration (a file under `configs/`) and its mix
(`traffic/<mix>.json`); each metric is read by `metrics/<name>.py` (a
function `read(run)` that returns a number, or None where it finds
nothing to read); the mix's `entry` names the port's entry point,
`routes/<entry>.py` (the class driven, its judge and its control,
`entries.py`); the configuration's `circuit` names
`circuits/<circuit>.py` (the traffic's build and the reference's answers,
`traffic.py`). A part named with no file refuses the run. A cell, a mix,
a metric, an entry point or a circuit is added with files and entries,
never with an edit here.

A run: the traffic is made from the seed by the plain reference
(`traffic.py`); the port's entry point is built and warmed up on that
traffic's first calls (its first call op by op, its second captures the
graph), which with the input build is the set-up; then for
`--seconds` the entry is called in a closed loop, one caller, each call
after the last returned, cycling the mix's calls. With `--trace 1` each
call is cut at the port's layers inside host spans; after the window the
first items it served are called once more through the entry's plain
`call`, whose outputs the traced ones must equal (the check
`traced_calls_differ`), and `profile_calls` more calls run under
`torch.profiler`. Once the window has closed the peak memory is read, the
port's state is freed, `sys.modules` is searched for JAX, and every call's
outputs are judged against the reference (`judge.py` and the entry's
`judge`). The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error and
the last key of the result.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import entries, files, judge, trace, traffic
from .files import Refused
from .reference import native

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "circuits_tpu")
RECALLED = 3  # the distinct items of a traced window called again plainly


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: dict
    config: dict
    mix: dict
    load: traffic.Load
    kind: str                       # the device's name
    setup_s: float = 0.0
    setup_parts: dict = field(default_factory=dict)
    calls: list = field(default_factory=list)   # (item, start, end)
    window_s: float = 0.0
    spans: dict = field(default_factory=dict)   # name -> [seconds]
    counters: dict = field(default_factory=dict)
    profile: dict | None = None

    @property
    def latencies(self) -> list[float]:
        return [end - start for _, start, end in self.calls]


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_files(root: Path, name: str):
    """(manifest, cell, configuration entry, configuration, mix) of the
    cell `name` under the checkout `root`."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(root / entry["file"])
    mix = load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json")
    return manifest, cell, entry, config, mix


def metrics_of(manifest: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones with
    `--trace 0`, the per-layer ones with `--trace 1`."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(root: Path, name: str):
    """`read` of `portbench/metrics/<name>.py`."""
    return files.load(root, "metrics", name).read


def require_cards(chips: int) -> str:
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell "
                      f"asks for {chips}")
    return torch.cuda.get_device_name(0)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_note() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def _window(entry, run: Run, seconds: float, spans=None) -> list:
    """Call the entry in a closed loop until `seconds` have passed; the
    last call that starts before the end is completed and counted."""
    order, outs = run.load.order, []
    start = time.perf_counter()
    deadline, k = start + seconds, 0
    while True:
        item = order[k % len(order)]
        t0 = time.perf_counter()
        if spans is None:
            out = entry.call(item, k)
        else:
            out = entry.call_traced(item, spans, k)
        t1 = time.perf_counter()
        run.calls.append((item, t0, t1))
        outs.append((item, out))
        k += 1
        if t1 >= deadline:
            break
    run.window_s = run.calls[-1][2] - start
    return outs


def _recall(entry, outs: list) -> int:
    """Call the first `RECALLED` distinct items of a traced window once more
    through the entry's plain `call` (the port's `run`), and return how many
    of them the traced call answered otherwise."""
    first = {}
    for item, out in outs:
        if item not in first and len(first) < RECALLED:
            first[item] = out
    return sum(entry.canonical(entry.call(item)) != entry.canonical(out)
               for item, out in first.items())


def _profile(entry, run: Run, first: int, calls: int) -> list:
    """`calls` whole calls under torch.profiler, after the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    spans = trace.Spans(labels=True)
    order, outs = run.load.order, []
    acts = [ProfilerActivity.CPU]
    if entry.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.LABEL + "window"):
            for k in range(first, first + calls):
                item = order[k % len(order)]
                outs.append((item, entry.call_traced(item, spans, k)))
            if entry.device.type == "cuda":
                torch.cuda.synchronize(entry.device)
    run.profile = trace.reduce_profile(prof, calls)
    return outs


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda", t_start: float | None = None,
             log=sys.stderr) -> tuple[dict, list]:
    """One run; returns (result, checks). `device` "cpu" runs the plain
    versions (the benchmark's CPU tests); the command line always asks for
    the card."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest, cell, _, config, mix = cell_files(root, workload)
    route = files.load(root, "routes", mix["entry"])
    if importlib.util.find_spec("circuits_tpu_torch") is None:
        raise Refused("the port, circuits_tpu_torch, is not in the checkout")
    if device == "cuda":
        kind = require_cards(cell["chips"])
    else:
        kind = "cpu"
    import torch

    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    parts = {}
    t = time.perf_counter()
    load = traffic.build(root, config, mix, seed)
    parts["inputs"] = time.perf_counter() - t
    parts.update({f"inputs.{k}": v for k, v in load.seconds.items()})
    parts["library"] = entries.library_seconds()
    entry = route.Entry(config, load, dev)
    parts.update(entry.warm())
    run = Run(cell, config, mix, load, kind)
    run.setup_s = time.perf_counter() - t_start
    run.setup_parts = parts
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
          + f"; setup_s {run.setup_s:.3f}; the reference's Poseidon "
          + ("native (g++)" if native.library() else "pure Python"),
          file=log, flush=True)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the traffic and the reference's state stay alive all run: out of the
    # collector's reach, they do not lengthen the collections that the
    # port's own allocations set off inside the window
    gc.collect()
    gc.freeze()

    recalled = []
    if traced:
        spans = trace.Spans()
        outs = _window(entry, run, seconds, spans)
        run.spans = dict(spans.durations)
        recalled = [("traced_calls_differ", _recall(entry, outs), 0)]
        outs += _profile(entry, run, len(outs), mix["profile_calls"])
    else:
        outs = _window(entry, run, seconds)
    lat = sorted(run.latencies)
    print(f"window: {len(lat)} calls in {run.window_s:.3f} s, latency min "
          f"{lat[0]:.6f} median {lat[len(lat) // 2]:.6f} max {lat[-1]:.6f} s",
          file=log, flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if device == "cuda" else 0
    run.counters = entry.counters()
    del entry
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks, failed = judge.judge(route, load, outs)
    checks += recalled
    correct = all(v <= limit for _, v, limit in checks)
    metrics = {}
    for m in metrics_of(manifest, workload, traced):
        value = reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": kind, "count": cell["chips"],
                "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(outs), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if traced and run.profile is not None:
        p = run.profile
        dev_info.update(busy_s=p["busy_s"], window_s=p["window_s"])
        ops = sorted(p["by_name"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [list(kv) for kv in ops],
                               "idle_gaps": p["gaps"]}
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, v, limit in checks}
    if device == "cuda":
        print("card: " + card_note(), file=log, flush=True)
    found = forbidden_modules()
    if found:
        raise Refused("the process holds " + ", ".join(found))
    return result, checks


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, checks = run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  t_start=t_start)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    for name, v, limit in checks:
        print(f"check {name} {v} limit {limit}", file=sys.stderr, flush=True)
    return 0
