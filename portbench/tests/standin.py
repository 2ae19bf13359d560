"""Stand-in cells for the benchmark's CPU tests, added the way a later
change adds a cell: files and manifest entries only. `make_root(tmp)` lays
out a checkout under `tmp` (BENCHMARK.json, a link to the port's package,
the stand-in configurations, mixes, entry points and circuits) whose
cells run in seconds on the CPU with the port's plain versions. One entry
point is added as a file: `standin.copied`, a copy of `rollup.run`'s route
under another name; one mix names an entry point that has no file. One
circuit is added as a file: `StandinMain`, a copy of `RollupMain`'s under
another name, which only the stand-in checkout holds; one configuration
names a circuit that has no file."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CONFIGS = {
    "rollup-4-16-2-2": dict(circuit="RollupMain", nTx=4, nLevels=16,
                            maxL1Tx=2, maxFeeTx=2),
    "withdraw-16": dict(circuit="Withdraw", nLevels=16),
    "standin-4-16-2-2": dict(circuit="StandinMain", nTx=4, nLevels=16,
                             maxL1Tx=2, maxFeeTx=2),
    "uncircuited-4-16-2-2": dict(circuit="Uncircuited", nTx=4, nLevels=16,
                                 maxL1Tx=2, maxFeeTx=2),
}
BATCHES = [dict(step=1, amount=1000), dict(step=3, amount=777)]
MIXES = {
    "standin-transfers": dict(entry="rollup.run", token=1,
                              load_amount=10_000_000, user_fee=126,
                              batches=BATCHES, refused_copies=[0],
                              profile_calls=1),
    # one account-creating deposit, two transfers, one NOP lane
    "standin-padded": dict(entry="rollup.run", token=1,
                           load_amount=10_000_000, user_fee=126,
                           batches=[dict(step=1, amount=500, l1_deposits=1,
                                         l2_transfers=2),
                                    dict(step=2, amount=300)],
                           profile_calls=1),
    "standin-copied": dict(entry="standin.copied", token=1,
                           load_amount=10_000_000, user_fee=126,
                           batches=BATCHES, refused_copies=[0],
                           profile_calls=1),
    "standin-unrouted": dict(entry="standin.unrouted", token=1,
                             load_amount=10_000_000, user_fee=126,
                             batches=BATCHES, profile_calls=1),
    "standin-backlog": dict(entry="withdraw.run", trees=2, leaves_per_tree=8,
                            tampered_per_lane=0.25, lanes_per_call=8,
                            orders=2, profile_calls=1),
}
# an entry point added as a file: the copy of another's route
ROUTES = {"standin.copied": "rollup.run"}
# a circuit added as a file: the copy of another's
CIRCUITS = {"StandinMain": "RollupMain"}
# the real cell whose metrics each stand-in reports
STANDS_FOR = {"standin.transfers": "rollup2048.transfers",
              "standin.padded": "rollup2048.transfers",
              "standin.backlog": "withdraw32.backlog",
              "standin.copied": "rollup2048.transfers",
              "standin.circuit": "rollup2048.transfers"}
CELLS = {
    "standin.transfers": ("rollup-4-16-2-2", "standin-transfers"),
    "standin.padded": ("rollup-4-16-2-2", "standin-padded"),
    "standin.backlog": ("withdraw-16", "standin-backlog"),
    "standin.copied": ("rollup-4-16-2-2", "standin-copied"),
    "standin.unrouted": ("rollup-4-16-2-2", "standin-unrouted"),
    "standin.circuit": ("standin-4-16-2-2", "standin-transfers"),
    "standin.uncircuited": ("uncircuited-4-16-2-2", "standin-transfers"),
}


def make_root(tmp: Path) -> Path:
    """A checkout under `tmp` holding the benchmark, the port and the
    stand-in cells beside the real ones; returns its root."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "circuits_tpu_torch").symlink_to(REPO / "circuits_tpu_torch")
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, config in CONFIGS.items():
        path = f"portbench/configs/{name}.json"
        (root / path).write_text(json.dumps(config))
        manifest["configs"].append(dict(name=name, source="stand-in",
                                        file=path, reduced=[],
                                        why="a CPU test's stand-in"))
    routes = root / "portbench" / "routes"
    for name, source in ROUTES.items():
        shutil.copyfile(routes / f"{source}.py", routes / f"{name}.py")
    circuits = root / "portbench" / "circuits"
    for name, source in CIRCUITS.items():
        shutil.copyfile(circuits / f"{source}.py", circuits / f"{name}.py")
    for name, mix in MIXES.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    for name, (config, mix) in CELLS.items():
        manifest["workloads"].append(dict(name=name, config=config,
                                          traffic=mix, chips=1,
                                          why="a CPU test's stand-in"))
    for group in ("end_to_end", "per_layer"):
        for m in manifest[group]:
            if "workloads" in m:  # a stand-in reports what its model does
                m["workloads"] += [c for c, real in STANDS_FOR.items()
                                   if real in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root

