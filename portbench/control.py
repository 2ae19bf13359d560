"""The control of `correct`: the plain reference put in the port's place
with one guarantee of the configurations broken, which the judge must
refuse.

The configurations state every output as an exact canonical element of
the BN254 scalar field (and, for Withdraw, ok False exactly for the
claims the tree does not hold). The control keeps the reference's own
outputs but leaves them reduced lazily, below 2p instead of below p (x +
p, which still fits 256 bits): the step that a faster field reduction
would tempt a change to take, one that a prover reading the values mod p
would not notice. It needs no card and no port; it is not run by the
benchmark's runs:

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints, for each seed, the judge's numbers at the cell's own size over as
many calls as the mix cycles twice, each beside its limit, and exits 0
when the judge refused the control on every seed.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import files, harness, judge, traffic  # noqa: E402


def outputs(route, load, calls: int) -> list:
    """The control's (item, output) for `calls` calls in the window's
    order, in the form the entry's calls return (`control` of
    `routes/<entry>.py`)."""
    traffic.answers(load, set(load.order))
    items = [load.order[k % len(load.order)] for k in range(calls)]
    return [(item, route.control(load, item)) for item in items]


def readings(root: Path, workload: str, seed: int) -> list:
    """The judge's checks on the control for one seed."""
    _, _, _, config, mix = harness.cell_files(root, workload)
    route = files.load(root, "routes", mix["entry"])
    load = traffic.build(root, config, mix, seed)
    calls = 2 * len(load.order) if len(load.order) < 64 else 64
    checks, _ = judge.judge(route, load, outputs(route, load, calls))
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    refused = True
    for seed in args.seeds:
        checks = readings(harness.ROOT, args.workload, seed)
        bad = any(v > limit for _, v, limit in checks)
        refused &= bad
        print(f"control {args.workload} seed {seed} refused {bad}: "
              + ", ".join(f"{n} {v} limit {lim}" for n, v, lim in checks),
              flush=True)
    return 0 if refused else 1


if __name__ == "__main__":
    sys.exit(main())
