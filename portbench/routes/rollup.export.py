"""`rollup.export`: the prover's handoff, `witness_vector.handoff(engine,
inp, path)`, one RollupMain batch a call: evaluated in full through the
engine's captured `debug_call` and, where the circuit accepts it, written
as a `.wtns` file for the prover; with its judge and its control.

Each call writes its own file under a directory made for the run in
`build/portbench/` of the checkout (local disk, where a coordinator writes
for its prover); the judge removes the directory once it has read it. The
judge's checks, in order, each with limit 0:

  files_malformed            calls with ok True whose file is missing, or
                             is not the snarkjs v2 container of the
                             configuration's signal count (magic, version,
                             n8 32, the prime, the count, the length)
  values_not_canonical       values in those files at p or above
  calls_wrong_ok             calls whose ok differs from the reference's
                             (False exactly for the refused copy)
  refused_handed_off         calls with ok False, returned or expected,
                             that left a file
  calls_wrong_inputs         files whose section IN differs from the
                             batch's input dict
  calls_wrong_outputs        calls whose returned public outputs, or those
                             written in the file, differ from the
                             reference's
  relations_failed           the reference checker's failures
                             (`reference/witness_check.py`, every relation
                             of the circuit re-derived in Python bigints)
                             on the first well-formed, canonical file of
                             each distinct batch
  calls_differ_from_checked  files of a batch whose bytes differ from
                             those of the file checked
"""

from __future__ import annotations

import filecmp
import hashlib
import itertools
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench.entries import warm
from portbench.reference import witness_check as wc
from portbench.reference.scalar import P

# the reference checker's processes
WORKERS = os.cpu_count() or 1
# the judge's checks, in order
CHECKS = ("files_malformed", "values_not_canonical", "calls_wrong_ok",
          "refused_handed_off", "calls_wrong_inputs", "calls_wrong_outputs",
          "relations_failed", "calls_differ_from_checked")
OUTPUTS = ("hash_global_inputs", "new_state_root", "new_exit_root",
           "new_last_idx", "acc_fee_out")


def _params(load) -> tuple:
    """(nTx, nLevels, maxL1Tx, maxFeeTx) of the load's batches."""
    bb = load.builders[0]
    return bb.maxNTx, bb.nLevels, bb.maxL1Tx, bb.totalFeeTransactions


def _path(load) -> Path:
    """A new name for one call's file in the run's directory, which the
    first call makes under `build/portbench/` of the checkout and keeps on
    the load it serves (the control has no Entry), and the judge
    removes."""
    if getattr(load, "handoff_files", None) is None:
        base = Path(load.root) / "build" / "portbench"
        base.mkdir(parents=True, exist_ok=True)
        load.handoff_files = (Path(tempfile.mkdtemp(prefix="handoff-",
                                                    dir=base)),
                              itertools.count())
    run_dir, names = load.handoff_files
    return run_dir / f"call-{next(names):06d}.wtns"


class Entry:
    """`witness_vector.handoff(engine, inp, path)`: a call returns (path,
    outputs dict of host ints or None, ok); the file at path exists only
    where ok is True."""

    def __init__(self, config: dict, load, device):
        from circuits_tpu_torch.engine.witness import RollupEngine

        self.load, self.device = load, device
        self.engine = RollupEngine(config["nTx"], config["nLevels"],
                                   config["maxL1Tx"], config["maxFeeTx"],
                                   device=device)
        self.route = self.engine.debug_call

    def warm(self) -> dict:
        return warm(self)

    def call(self, i: int, index: int = 0):
        from circuits_tpu_torch.engine.witness_vector import handoff

        path = _path(self.load)
        out, ok = handoff(self.engine, self.load.items[i], path)
        return str(path), out, ok

    def call_traced(self, i: int, spans, index: int = 0):
        # the port's own spans (export.*) cut the call
        with spans("handoff"):
            return self.call(i, index)

    @staticmethod
    def canonical(out):
        path, _, ok = out
        p = Path(path)
        digest = hashlib.sha256(p.read_bytes()).hexdigest() \
            if p.exists() else None
        return digest, ok

    def counters(self) -> dict:
        return {"graph_nodes": self.route.nodes}


def _not_canonical(section) -> int:
    """Values of a values section at p or above (32-byte little-endian)."""
    words = np.frombuffer(section, dtype="<u8").reshape(-1, 4)
    above = np.zeros(len(words), dtype=bool)
    equal = np.ones(len(words), dtype=bool)
    for k in (3, 2, 1, 0):
        limb = np.uint64((P >> (64 * k)) & ((1 << 64) - 1))
        above |= equal & (words[:, k] > limb)
        equal &= words[:, k] == limb
    return int((above | equal).sum())


def judge(load, calls, failed):
    """The checks of `calls`, (item, (path, outputs, ok)) in the window's
    order; adds the position of each call that fails one to `failed`, and
    removes the run's directory."""
    t = time.perf_counter()
    try:
        return _judge(load, calls, failed)
    finally:
        print(f"judge: {len(calls)} calls in {time.perf_counter() - t:.3f} "
              f"s", file=sys.stderr, flush=True)
        if getattr(load, "handoff_files", None) is not None:
            shutil.rmtree(load.handoff_files[0], ignore_errors=True)
            load.handoff_files = None


def _judge(load, calls, failed):
    params = _params(load)
    count, F = len(wc.signal_names(*params)), params[3]
    n_in = len(wc.in_names(params[0], F, params[1] + 1))
    tail = count - F - 3
    wrong = dict.fromkeys(CHECKS, 0)
    checked, in_bytes = {}, {}  # a batch's first sound file; its IN

    def bad(key, pos, n=1):
        if n:
            wrong[key] += n
            failed.add(pos)

    for pos, (item, (path, out, ok)) in enumerate(calls):
        exp = load.expected[item]
        p = Path(path)
        bad("calls_wrong_ok", pos, ok is not exp["ok"])
        if not (ok and exp["ok"]):
            bad("refused_handed_off", pos, p.exists())
            continue
        section = wc.wtns_values(p.read_bytes(), count) if p.exists() \
            else None
        if section is None:
            bad("files_malformed", pos)
            bad("calls_wrong_outputs", pos,
                any((out or {}).get(k) != exp[k] for k in OUTPUTS))
            continue
        high = _not_canonical(section)
        bad("values_not_canonical", pos, high)
        if item not in in_bytes:
            in_bytes[item] = wc.le_bytes(
                wc.in_values(load.items[item], *params))
        bad("calls_wrong_inputs", pos,
            bytes(section[64:32 * (2 + n_in)]) != in_bytes[item])
        written = wc.to_ints(section[32:64]) + \
            wc.to_ints(section[32 * tail:])
        want = [exp["hash_global_inputs"], exp["new_last_idx"],
                exp["new_state_root"], exp["new_exit_root"],
                *exp["acc_fee_out"]]
        bad("calls_wrong_outputs", pos, written != want
            or any((out or {}).get(k) != exp[k] for k in OUTPUTS))
        if not high:
            checked.setdefault(item, (pos, p))

    # every relation of each distinct batch, on its first file that is
    # well formed and canonical; the batch's other files byte for byte
    t = time.perf_counter()
    results = wc.verify_files({item: p for item, (_, p) in checked.items()},
                              params, WORKERS) if checked else {}
    print(f"judge: every relation of {len(checked)} batches in "
          f"{time.perf_counter() - t:.3f} s on {WORKERS} processes",
          file=sys.stderr, flush=True)
    for item, (pos, _) in checked.items():
        bad("relations_failed", pos, len(results[item]["failures"]))
    for pos, (item, (path, _, _)) in enumerate(calls):
        if item in checked and Path(path).exists() and \
                pos != checked[item][0]:
            same = filecmp.cmp(checked[item][1], path, shallow=False)
            bad("calls_differ_from_checked", pos, not same)
    return [(k, n, 0) for k, n in wrong.items()]


def control(load, item):
    """The reference's handoff of `item` with every value that it knows
    left lazily reduced: a file of the right header and count whose section
    IN and public outputs are written as x + p and whose intermediates are
    zero, with the public outputs returned as x + p too; nothing for a
    batch the circuit refuses."""
    exp = load.expected[item]
    path = _path(load)
    if not exp["ok"]:
        return str(path), None, False
    params = _params(load)
    names = wc.signal_names(*params)
    F = params[3]
    ins = wc.in_values(load.items[item], *params)
    outs = [exp["new_last_idx"], exp["new_state_root"],
            exp["new_exit_root"], *exp["acc_fee_out"]]
    values = [1, exp["hash_global_inputs"] + P] + [v + P for v in ins]
    values += [0] * (len(names) - len(values) - len(outs))
    values += [v + P for v in outs]
    assert len(values) == len(names) and len(outs) == F + 3
    path.write_bytes(wc.wtns_bytes(values))
    out = {k: (exp[k] + P if k != "acc_fee_out"
               else [v + P for v in exp[k]]) for k in OUTPUTS}
    return str(path), out, True
