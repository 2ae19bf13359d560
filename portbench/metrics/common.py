"""What the readers share: a span's mean, a percentile, the profile's
kernel times and the rooflines' least time."""

from __future__ import annotations

import statistics

from . import peak, workcount

# the port's kernels K1-K4 (circuits_tpu_torch/csrc), by the names of
# their __global__ functions as the profiler reports them
KERNELS = {"K1": "poseidon_permute_kernel", "K2": "smt_chain_kernel",
           "K3": "eddsa_kernel", "K4": "sha256_chain"}
# the profiler's names of copies and fills, which are no kernel
COPIES = ("Memcpy", "Memset")


def span_mean(run, name: str):
    """Mean seconds of a host span, None without one."""
    spans = run.spans.get(name)
    return statistics.fmean(spans) if spans else None


def percentile(values: list[float], q: int) -> float:
    """The q-th percentile (1..99) of `values`, Python's inclusive
    quantiles."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def kernel_seconds(run, kernels=None):
    """Device seconds a profiled call of the named kernels (all four by
    default; a kernel is matched by name), or of every other kernel with
    kernels=() (copies and fills left out); None without a profile or
    without device time."""
    p = run.profile
    if not p or not p["busy_s"]:
        return None
    names = list(KERNELS.values()) if kernels is None else kernels
    if kernels == ():
        total = sum(s for n, s in p["by_name"].items()
                    if not n.startswith(COPIES)
                    and not any(k in n for k in KERNELS.values()))
    else:
        total = sum(s for n, s in p["by_name"].items()
                    if any(k in n for k in names))
    return total / p["calls"]


def roofline_share(run, kernels: tuple[str, ...]):
    """The named kernels' least time for the profiled calls' circuit work
    (`workcount.py` on the card's fixed peak, `peak.py`), over their
    profiled device time, in %; None where either is missing."""
    measured = kernel_seconds(run, [KERNELS[k] for k in kernels])
    if not measured:
        return None
    order = run.load.order
    first = len(run.calls)
    items = [order[k % len(order)]
             for k in range(first, first + run.profile["calls"])]
    least = 0.0
    for item in items:
        ops, moved = workcount.least_ops_and_bytes(
            run.load.work[item], peak.MONT_MUL, peak.MONT_SQR,
            peak.SHA_BLOCK_OPS)
        s = peak.least_seconds(ops, moved, run.kind)
        if s is None:
            return None
        least += s[0]
    return 100.0 * least / len(items) / measured


def idle_share(run):
    """The device's idle share of the profiled sub-window, in %."""
    p = run.profile
    if not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
