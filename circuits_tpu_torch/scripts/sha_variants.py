"""Time kernel K4 (csrc/sha256.cu) against variants of its source on one
CUDA card, every variant in turns within one process and held to the same
digests.

    python -m circuits_tpu_torch.scripts.sha_variants routes
    python -m circuits_tpu_torch.scripts.sha_variants compare DIR [DIR ...]

`routes` times the kernel's two routes over lane and block counts: it
builds two copies of csrc/ under build/, one that serves every batch by the
narrow route (a block a lane) and one that serves every batch by the wide
one (a thread a lane), by rewriting NARROW_LANES_PER_SM. This is the
measurement behind that constant and behind keeping two routes: 2 blocks a
lane is a batch of withdrawals. `compare` times the tree's kernel and
each DIR (a whole copy of csrc/ with an edited sha256.cu) at the rollup's
shape, 822 blocks x 1 lane. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import re
import shutil
import sys
from pathlib import Path

import torch

from .. import kernels
from ..ops import sha256
from .exp_mxu_inkernel import card_line

TREE = kernels.CSRC
ROUTE_LANES = (1, 16, 128, 512, 528, 529, 640, 1024, 2048, 4096, 32768)
ROUTE_BLOCKS = (2, 8, 64)
MAIN_PATH = (1, 822)  # lanes, blocks of the rollup's HashInputs preimage


def mean_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def route_copy(name: str, lanes_per_sm: int) -> Path:
    """A copy of csrc/ under build/ whose K4 takes the narrow route up to
    `lanes_per_sm` lanes an SM."""
    dst = kernels.BUILD_DIR / "variants" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(TREE, dst)
    src = (dst / "sha256.cu").read_text()
    new, count = re.subn(r"(constexpr int NARROW_LANES_PER_SM = )\d+;",
                         rf"\g<1>{lanes_per_sm};", src)
    assert count == 1, "NARROW_LANES_PER_SM not found in sha256.cu"
    (dst / "sha256.cu").write_text(new)
    return dst


def load_sources(csrc: Path) -> Path:
    """Have `kernels` build and load its library from another copy of
    csrc/ from now on; returns that library's path, which is named by a
    hash of the sources."""
    kernels.CSRC, kernels._lib = Path(csrc), None
    kernels._prepared.clear()
    kernels._functions.clear()
    return kernels.library_path()


def time_variants(variants: dict, cases: dict, reps: int) -> dict:
    """{case: {variant: [ms, ms]}}: every variant twice, in the order a, b,
    ..., b, a; a digest that differs between variants raises."""
    dev = torch.device("cuda", 0)
    want, times = {}, {}
    libraries = {load_sources(csrc) for csrc in variants.values()}
    assert len(libraries) == len(variants), "two variants have one source"
    order = list(variants) + list(variants)[::-1]
    for name in order:
        load_sources(variants[name])
        kernels.prepare(dev)
        for case, words in cases.items():
            got = sha256.sha256_chain(words, case[1])
            if not torch.equal(want.setdefault(case, got), got):
                raise AssertionError(f"{name} differs at {case}")
            ms = mean_ms(lambda: sha256.sha256_chain(words, case[1]), reps)
            times.setdefault(case, {}).setdefault(name, []).append(ms)
    return times


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sha_variants: needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(4)

    def words(lanes, nblocks):
        return torch.randint(0, 1 << 32, (nblocks * 16, lanes), generator=gen,
                             dtype=torch.int64).to(dev)

    if argv[:1] == ["routes"]:
        variants = {"narrow": route_copy("narrow", 1 << 20),
                    "wide": route_copy("wide", 0)}
        cases = {(b, n): words(b, n) for n in ROUTE_BLOCKS
                 for b in ROUTE_LANES}
    elif argv[:1] == ["compare"] and len(argv) > 1:
        variants = {"tree": TREE, **{d: Path(d) for d in argv[1:]}}
        cases = {MAIN_PATH: words(*MAIN_PATH)}
    else:
        raise SystemExit(__doc__)
    times = time_variants(variants, cases, reps=20)
    print(f"card: {card_line()}", flush=True)
    print("lanes blocks " + " ".join(f"{v}_ms(two runs)" for v in variants))
    for (lanes, nblocks), row in times.items():
        print(lanes, nblocks, *(" ".join(f"{ms:.4f}" for ms in row[v])
                                for v in variants), sep="  ", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
