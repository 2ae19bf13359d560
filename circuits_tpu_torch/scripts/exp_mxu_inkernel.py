"""The full-round experiment on one CUDA card: Poseidon t=3 full rounds with
the MDS mix on the CUDA cores (K5) against the mix on the tensor cores
(K6).

    python -m circuits_tpu_torch.scripts.exp_mxu_inkernel [lanes=65536] [rounds=16]

Both kernels run `rounds` consecutive full rounds (ARK + x^5 + MDS mix) on
the same Montgomery-form random state, drawn from
`np.random.default_rng(5)`. Every lane of the two outputs must agree, and
lanes 0, 777 and lanes-1 must equal the bigint mirror. Each kernel is then
timed as the median of 7 runs (CUDA events) after a warm-up. Needs a CUDA
device; raises without one.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import numpy as np
import torch

from ..field import fr
from ..field import scalar
from ..ops import poseidon_rounds

T3 = 3
KERNELS = (("K5", "poseidon_rounds_vpu", poseidon_rounds.full_rounds_vpu),
           ("K6", "poseidon_rounds_mxu", poseidon_rounds.full_rounds_mxu))


def random_state(lanes: int, seed: int = 5):
    """(16, 3, lanes) int64 Montgomery limbs on the CPU, and the values as
    3 lists of Python ints."""
    rng = np.random.default_rng(seed)
    vals = [[int(v) * scalar.R % scalar.P
             for v in rng.integers(0, 1 << 62, size=lanes)]
            for _ in range(T3)]
    return fr.pack(vals), vals


def card_line() -> str:
    """The card as `nvidia-smi` names it, with its power limit."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 7) -> float:
    """Median device time of `fn` over `reps` calls, each between two CUDA
    events; the caller has made a warm-up call."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(lanes: int = 65536, rounds: int = 16, device=None) -> dict:
    """Run, check and time both kernels; returns {"K5": ms, "K6": ms}."""
    if not torch.cuda.is_available():
        raise RuntimeError("exp_mxu_inkernel needs a CUDA device")
    dev = torch.device(device or "cuda")
    state, vals = random_state(lanes)
    x = state.to(dev)
    outs = {name: fn(x, rounds) for name, _, fn in KERNELS}
    torch.cuda.synchronize(dev)
    if not torch.equal(outs["K5"], outs["K6"]):
        bad = int((outs["K5"] != outs["K6"]).any(dim=0).any(dim=0).sum())
        raise AssertionError(f"K5 and K6 differ in {bad} of {lanes} lanes")
    got = fr.unpack_np(outs["K5"])
    for lane in sorted({0, 777, lanes - 1} & set(range(lanes))):
        want = poseidon_rounds.full_rounds_py(
            [vals[e][lane] for e in range(T3)], rounds)
        if [int(got[e, lane]) for e in range(T3)] != want:
            raise AssertionError(f"lane {lane} differs from the bigint mirror")
    print(f"K5 == K6 in all {lanes} lanes, and both equal the bigint mirror "
          f"({rounds} rounds)", flush=True)
    card = card_line()
    times = {}
    for name, kernel, fn in KERNELS:
        times[name] = median_ms(lambda: fn(x, rounds))
        ns = times[name] * 1e6 / rounds / lanes
        print(f"{name} {kernel}: {times[name]:.4f} ms for {rounds} rounds x "
              f"{lanes} lanes -> {ns:.4f} ns/round/lane on {card}",
              flush=True)
    return times


def main(argv: list[str]) -> None:
    lanes = int(argv[0]) if len(argv) > 0 else 65536
    rounds = int(argv[1]) if len(argv) > 1 else 16
    run(lanes, rounds)


if __name__ == "__main__":
    main(sys.argv[1:])
