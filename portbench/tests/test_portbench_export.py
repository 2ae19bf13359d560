"""The prover's handoff cell (`rollup.export`) on the CPU with the port's
plain versions, at a stand-in cell added the way a later change adds one:
`standin.make_root` and, beside it, this module's mix, cell and manifest
entries. The stand-in runs correct, traced and untraced; each planted
fault turns `correct` false on its check; the control, the reference with
every value lazily reduced, is refused on two seeds through `control.py`'s
command line; and the run's directory of files is gone after the judge."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

SEED = 2**31 + 1019
CELL = "standin.export"
MIX = dict(entry="rollup.export", token=1, load_amount=10_000_000,
           user_fee=126, batches=[dict(step=1, amount=1000),
                                  dict(step=3, amount=777)],
           refused_copies=[0], profile_calls=1)
PARAMS = (4, 16, 2, 2)
# the file of a handed-off RollupMain(4, 16, 2, 2) batch: 4,503 values
WTNS_BYTES = 76 + 32 * 4_503


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The stand-in checkout with the export cell at RollupMain(4, 16, 2,
    2), reporting what `rollup2048.export` reports."""
    from portbench.tests import standin

    root = standin.make_root(tmp_path_factory.mktemp("export"))
    (root / "portbench" / "traffic" / "standin-handoff.json").write_text(
        json.dumps(MIX))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append(dict(name=CELL, config="rollup-4-16-2-2",
                                      traffic="standin-handoff", chips=1,
                                      why="a CPU test's stand-in"))
    for group in ("end_to_end", "per_layer"):
        for m in manifest[group]:
            if "rollup2048.export" in m.get("workloads", ()):
                m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root


def calls(monkeypatch, order):
    """Have the window serve exactly the items `order` (a CPU call takes
    seconds, so a window of these seconds makes one call): the load's
    order becomes `order`, and the window is that many one-call windows."""
    from portbench import traffic

    real_build, real_window = traffic.build, harness._window

    def build(root, config, mix, seed):
        load = real_build(root, config, mix, seed)
        load.order = list(order)
        return load

    def window(entry, run, seconds, spans=None):
        outs = []
        for k in range(len(order)):
            run.load.order = order[k:] + order[:k]
            outs += real_window(entry, run, 0.0, spans)
        run.load.order = list(order)
        return outs
    monkeypatch.setattr(traffic, "build", build)
    monkeypatch.setattr(harness, "_window", window)


def run(root, traced=False, seed=SEED):
    result, checks = harness.run_cell(root, CELL, seed, 0.01, traced,
                                      device="cpu")
    return result, {n: v for n, v, _ in checks}


def handoff_dirs(root):
    return sorted((root / "build" / "portbench").glob("handoff-*"))


def test_port_matches_reference(root, monkeypatch):
    calls(monkeypatch, [0, 2, 1, 0])
    result, checks = run(root)
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] == 4
    assert list(checks) == [
        "calls_missing", "files_malformed", "values_not_canonical",
        "calls_wrong_ok", "refused_handed_off", "calls_wrong_inputs",
        "calls_wrong_outputs", "relations_failed",
        "calls_differ_from_checked"]
    assert not any(checks.values())
    assert {"setup_s", "batch_s"} <= set(result["metrics"])
    assert not handoff_dirs(root)


def test_traced_run_reads_the_export_spans(root, monkeypatch):
    calls(monkeypatch, [0, 2, 1])
    result, checks = run(root, traced=True)
    assert result["correct"], checks
    assert checks["traced_calls_differ"] == 0
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(m) == {"evaluate_s.export", "read_s.export",
                      "write_s.export", "wtns_bytes.export"}
    assert m["wtns_bytes.export"] == WTNS_BYTES
    assert all(m[k] > 0 for k in m)


def _fault(kind):
    """A fault of the port's handoff, planted under the timed path."""
    from circuits_tpu_torch.engine import witness_vector as wv
    from portbench.reference import witness_check as wc
    from portbench.reference.scalar import P

    if kind == "intermediate + 1":
        real = wv._vector

        def vector(engine, inp, lanes, out):
            values = real(engine, inp, lanes, out)
            k = wv.signal_names(*engine.params).index(
                "main.Tx[1].newStHash1")
            values[k] = (values[k] + 1) % P
            return values
        return wv, "_vector", vector
    if kind == "later file altered":
        real, seen = wv.write_wtns, {}

        def write(path, values):
            n = real(path, values)
            # a batch handed off twice before (in the warm-up and in the
            # window): one flag's byte flipped
            seen[values[1]] = seen.get(values[1], 0) + 1
            if seen[values[1]] > 2:
                k = wv.signal_names(*PARAMS).index("main.Tx[1].states.nop")
                data = bytearray(Path(path).read_bytes())
                data[76 + 32 * k] ^= 1
                Path(path).write_bytes(bytes(data))
            return n
        return wv, "write_wtns", write
    if kind == "value x + p":
        def write(path, values):
            values = [v % P for v in values]
            values[-1] += P
            data = wc.wtns_bytes(values)
            Path(path).write_bytes(data)
            return len(data)
        return wv, "write_wtns", write
    if kind == "refused handed off":
        real = wv.handoff

        def handoff(engine, inp, path):
            out, ok = real(engine, inp, path)
            if not ok:
                wv.write_wtns(path, wv.export_witness(engine, inp)[1])
            return out, ok
        return wv, "handoff", handoff
    raise ValueError(kind)


@pytest.mark.parametrize("kind,order,check", [
    ("intermediate + 1", [0, 1], "relations_failed"),
    ("later file altered", [0, 2, 0], "calls_differ_from_checked"),
    ("value x + p", [1], "values_not_canonical"),
    ("refused handed off", [2, 0], "refused_handed_off"),
])
def test_fault_turns_correct_false(root, monkeypatch, kind, order, check):
    calls(monkeypatch, order)
    monkeypatch.setattr(*_fault(kind))
    result, checks = run(root)
    assert not result["correct"] and result["failed"] >= 1
    assert checks[check] > 0, checks
    # nothing before the named check moved
    names = list(checks)
    assert not any(checks[n] for n in names[:names.index(check)]), checks
    assert not handoff_dirs(root)


def test_control_is_refused_on_two_seeds(root):
    out = subprocess.run(
        [sys.executable, str(root / "portbench" / "control.py"),
         "--workload", CELL, "--seeds", "1", "2"],
        capture_output=True, text=True, timeout=600, cwd=root,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2 and all("refused True" in x for x in lines)
    assert all("values_not_canonical 0 " not in x for x in lines)
    assert not handoff_dirs(root)


@pytest.mark.gpu
def test_export_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, str(harness.ROOT / "portbench" / "run.py"),
         "--workload", "rollup2048.export", "--seed", str(SEED),
         "--seconds", "5", "--trace", "0"], capture_output=True, text=True,
        timeout=1800, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
