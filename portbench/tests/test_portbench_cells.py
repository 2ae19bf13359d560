"""The harness on the CPU with the port's plain versions, at stand-in cells
that `standin.py` adds as files and manifest entries only: the port
(`device="cpu"`) against the reference at a tiny RollupMain and Withdraw
shape, through the same entries and judge as the card's runs; the
control, the reference with a guarantee broken, refused; each fault a
cell can have, planted under the timed path, turning `correct` false; and
a traced run held to the port's plain `run`.
A test that needs the card is marked `gpu` and skips here."""

import json
import os
import subprocess
import sys

import pytest

from portbench import control, harness
from portbench.metrics import common, workcount

SEED = 2**31 + 1009


def refused_first(monkeypatch):
    """Have the window start on the refused batches (a CPU window at these
    seconds makes a single call)."""
    from portbench import traffic

    real = traffic.build

    def build(root, config, mix, seed):
        load = real(root, config, mix, seed)
        load.order.sort(key=lambda i: load.expected[i]["ok"])
        return load
    monkeypatch.setattr(traffic, "build", build)


def run(root, cell, traced=False, seed=SEED):
    result, checks = harness.run_cell(root, cell, seed, 0.01, traced,
                                      device="cpu")
    return result, {n: v for n, v, _ in checks}


@pytest.mark.parametrize("cell", ["standin.transfers", "standin.padded",
                                  "standin.backlog", "standin.copied",
                                  "standin.circuit"])
def test_port_matches_reference(standin_root, cell):
    result, checks = run(standin_root, cell)
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] >= 1 and not any(checks.values())
    assert "setup_s" in result["metrics"]
    assert list(result)[-1] == "checks"


def test_traced_run_reads_its_spans(standin_root):
    result, _ = run(standin_root, "standin.backlog", traced=True)
    assert result["correct"]
    m = result["metrics"]
    assert set(m) == {"pack_s.withdraw", "replay_s.withdraw"}
    # no device on the CPU: the device metrics read nothing, never 0
    assert "kernels_roofline.withdraw" not in m
    assert result["device"]["window_s"] > 0
    assert result["checks"]["traced_calls_differ"]["value"] == 0


def test_refused_copy_expected_refused(standin_root, monkeypatch):
    """The transfers mix cycles a copy of its first batch with one lane's
    signature altered: the reference expects ok False there and the
    original's outputs otherwise, and the port agrees."""
    from portbench import traffic
    from portbench.tests import standin

    load = traffic.build(standin_root, standin.CONFIGS["rollup-4-16-2-2"],
                         standin.MIXES["standin-transfers"], SEED)
    assert [e["ok"] for e in load.expected] == [True, True, False]
    differ = [k for k, (a, b) in enumerate(zip(load.items[0]["s"],
                                               load.items[2]["s"])) if a != b]
    assert len(differ) == 1
    assert {k for k in load.expected[2] if k != "ok"} == {
        k for k in load.expected[0] if k != "ok"}
    refused_first(monkeypatch)
    result, checks = run(standin_root, "standin.transfers")
    assert result["correct"] and not any(checks.values()), checks


def test_traced_fork_held_to_run(standin_root, monkeypatch):
    """A change to the port's `run` that the traced calls do not follow
    turns `correct` false in a traced run."""
    from circuits_tpu_torch.engine.witness import WithdrawEngine

    real = WithdrawEngine.run

    def run_(self, inputs):
        h, ok = real(self, inputs)
        h[0] ^= 1
        return h, ok
    monkeypatch.setattr(WithdrawEngine, "run", run_)
    result, checks = run(standin_root, "standin.backlog", traced=True)
    assert not result["correct"] and checks["traced_calls_differ"] > 0


@pytest.mark.parametrize("cell", ["standin.transfers", "standin.backlog",
                                  "standin.copied", "standin.circuit"])
def test_control_is_refused(standin_root, cell):
    checks = control.readings(standin_root, cell, SEED)
    assert any(v > limit for _, v, limit in checks)


def _rollup_fault(kind):
    from circuits_tpu_torch.engine.witness import RollupEngine

    real = RollupEngine.run

    def run_(self, inp):
        out, ok = real(self, inp)
        if kind == "state unchanged":
            out["new_state_root"] = int(inp["oldStateRoot"])
        elif kind == "answer altered":
            out["hash_global_inputs"] ^= 1
        elif kind == "ok forced True":
            ok = True
        return out, ok
    return RollupEngine, "run", run_


def _withdraw_fault(kind):
    from circuits_tpu_torch.engine.witness import WithdrawEngine

    real = WithdrawEngine.run

    def run_(self, inputs):
        if kind == "half left out":
            half = len(inputs) // 2
            h, ok = real(self, inputs[:half] + inputs[:half])
            return h, ok
        h, ok = real(self, inputs)
        h[-1] ^= 1
        return h, ok
    return WithdrawEngine, "run", run_


@pytest.mark.parametrize("cell,fault,kind,check", [
    ("standin.transfers", _rollup_fault, "state unchanged",
     "calls_wrong_new_state_root"),
    ("standin.transfers", _rollup_fault, "answer altered",
     "calls_wrong_hash_global_inputs"),
    ("standin.transfers", _rollup_fault, "ok forced True", "calls_wrong_ok"),
    ("standin.backlog", _withdraw_fault, "half left out", "lanes_wrong_hash"),
    ("standin.backlog", _withdraw_fault, "answer altered",
     "lanes_wrong_hash"),
    ("standin.copied", _rollup_fault, "answer altered",
     "calls_wrong_hash_global_inputs"),
    ("standin.circuit", _rollup_fault, "answer altered",
     "calls_wrong_hash_global_inputs"),
])
def test_fault_turns_correct_false(standin_root, monkeypatch, cell, fault,
                                   kind, check):
    monkeypatch.setattr(*fault(kind))
    if kind == "ok forced True":
        refused_first(monkeypatch)
    result, checks = run(standin_root, cell)
    assert not result["correct"] and result["failed"] >= 1
    assert checks[check] > 0


def test_entry_without_a_file_is_refused(standin_root):
    """A mix whose entry point has no file under `routes/` is a refused
    run, one that names the missing file, and the command line exits 2
    with no result."""
    with pytest.raises(harness.Refused,
                       match=r"portbench/routes/standin\.unrouted\.py"):
        harness.run_cell(standin_root, "standin.unrouted", SEED, 0.01, False,
                         device="cpu")
    out = subprocess.run(
        [sys.executable, str(standin_root / "portbench" / "run.py"),
         "--workload", "standin.unrouted", "--seed", str(SEED), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=standin_root, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 2 and not out.stdout.strip(), out.stderr[-3000:]
    assert "portbench/routes/standin.unrouted.py" in out.stderr


def test_circuit_found_under_the_runs_root(standin_root):
    """A configuration's circuit is found under the checkout the run is
    given, as its entry point is: the stand-in checkout's added circuit
    builds there and not under the repo's own root; a configuration whose
    circuit has no file is a refused run, one that names the missing
    file."""
    from portbench import traffic
    from portbench.tests import standin

    config = standin.CONFIGS["standin-4-16-2-2"]
    mix = standin.MIXES["standin-transfers"]
    assert traffic.build(standin_root, config, mix, SEED).root == \
        standin_root
    with pytest.raises(harness.Refused,
                       match=r"portbench/circuits/StandinMain\.py"):
        traffic.build(harness.ROOT, config, mix, SEED)
    with pytest.raises(harness.Refused,
                       match=r"portbench/circuits/Uncircuited\.py"):
        harness.run_cell(standin_root, "standin.uncircuited", SEED, 0.01,
                         False, device="cpu")


def test_workcount_of_a_transfers_batch():
    from portbench import traffic
    from portbench.tests import standin

    load = traffic.build(harness.ROOT, standin.CONFIGS["rollup-4-16-2-2"],
                         standin.MIXES["standin-transfers"], SEED)
    w = load.work[0]["permutations"]
    # four signed transfers, both processors UPDATE, one fee slot
    assert w[7] == w[6] == load.work[0]["eddsa"] == 4
    assert w[5] == 4 * 4 + 2 and w[4] == 4 * 4 + 2
    # a deposit (INSERT, processor 2 a NOP), two transfers, a NOP lane
    load = traffic.build(harness.ROOT, standin.CONFIGS["rollup-4-16-2-2"],
                         standin.MIXES["standin-padded"], SEED)
    w = load.work[0]["permutations"]
    assert w[7] == w[6] == load.work[0]["eddsa"] == 2
    # the new leaf's hash, and the old leaf's where the slot held one
    leaves = 1 if load.items[0]["isOld0_1"][0] else 2
    assert w[5] == 1 + 2 * 2 + 2 * 2 + 2 and w[4] == leaves + 2 * 4 + 2
    sq, pr = workcount.poseidon_products(3)
    assert sq + pr == 8 * (9 + 9) + 57 * 8  # the sparse schedule's products


def test_roofline_share_reads_nothing_without_a_profile(standin_root):
    class Stub:
        profile = None
    assert common.roofline_share(Stub(), ("K1",)) is None
    assert common.idle_share(Stub()) is None


def test_no_jax_in_a_run(standin_root, tmp_path):
    """A stand-in run in a process where every `jax*` and `circuits_tpu`
    import is blocked; the harness's own search of `sys.modules` compares
    whole top-level names, so `circuits_tpu_torch` passes."""
    script = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "circuits_tpu"):
            raise ImportError(name + " is blocked")
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(harness.ROOT)!r})
from pathlib import Path
from portbench import harness
res, _ = harness.run_cell(Path({str(standin_root)!r}), "standin.backlog",
                          {SEED}, 0.01, False, device="cpu")
assert res["correct"], res
assert "circuits_tpu_torch" in sys.modules
assert not harness.forbidden_modules()
print("OK")
"""
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.stdout.strip().endswith("OK"), out.stderr[-3000:]


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "circuits_tpu_torch_x", sys)
    assert "circuits_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "circuits_tpu.field", sys)
    assert "circuits_tpu" in harness.forbidden_modules()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["rollup2048.transfers",
                                  "withdraw32.backlog", "withdraw32.single"])
def test_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, str(harness.ROOT / "portbench" / "run.py"),
         "--workload", cell, "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=1200,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def _top_level_imports(path):
    import ast

    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    """No file of the benchmark imports JAX or the JAX package (whole
    top-level names), and the reference imports nothing of the port."""
    bench = harness.ROOT / "portbench"
    for path in bench.rglob("*.py"):
        names = _top_level_imports(path)
        assert not names & set(harness.FORBIDDEN), path
        if "reference" in path.parts:
            assert "circuits_tpu_torch" not in names, path
    # the harness's side: only the entry points' files and what they share
    # import the port
    port_users = {p.relative_to(bench).as_posix()
                  for p in bench.rglob("*.py")
                  if "tests" not in p.parts
                  and "circuits_tpu_torch" in _top_level_imports(p)}
    routes = {p.relative_to(bench).as_posix()
              for p in (bench / "routes").glob("*.py")}
    assert port_users == {"entries.py"} | routes
