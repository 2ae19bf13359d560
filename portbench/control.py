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

from portbench import harness, judge, traffic  # noqa: E402
from portbench.reference.scalar import P  # noqa: E402


def lazy(x: int) -> int:
    """x as a lazily reduced value: x + p, in [p, 2p)."""
    return x + P


def outputs(entry: str, load, calls: int) -> list:
    """The control's (item, output) for `calls` calls in the window's
    order, in the form the entry's calls return."""
    traffic.answers(load, set(load.order))
    outs = []
    for k in range(calls):
        item = load.order[k % len(load.order)]
        exp = load.expected[item]
        if entry == "rollup.run":
            out = {key: (lazy(exp[key]) if key != "acc_fee_out"
                         else [lazy(v) for v in exp[key]])
                   for key in judge.ROLLUP_FIELDS[:-1]}
            outs.append((item, (out, exp["ok"])))
        elif entry == "withdraw.run":
            outs.append((item, ([lazy(h) for h in exp["hash"]], exp["ok"])))
        else:
            raise ValueError(f"unknown entry {entry!r}")
    return outs


def readings(root: Path, workload: str, seed: int) -> list:
    """The judge's checks on the control for one seed."""
    _, _, _, config, mix = harness.cell_files(root, workload)
    load = traffic.build(config, mix, seed)
    calls = 2 * len(load.order) if len(load.order) < 64 else 64
    checks, _ = judge.judge(mix["entry"], load,
                            outputs(mix["entry"], load, calls))
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
