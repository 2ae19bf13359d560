"""The port's CLI (`circuits_tpu_torch.tools.cli`) verb by verb against
the JAX package's CLI (`circuits_tpu.tools.cli`) at test_cli.py's shape
(4, 16, 4, 2), the port's engine verbs with `--device cpu`: the same
`config.json` and `inputs-4.json` bytes and printed hash, the same
`out.json` apart from the time, the same `.wtns` and `.sym.json` bytes, the
same `trace` JSON (whole catalog and one signal), the same exit codes of
`check` on a sound and a tampered batch and of `zkey`, the same `audit`
report on a stand-in for the reference's circom sources and without
them. Without `--device`, an engine verb asks for the card and raises
where there is none."""

import contextlib
import io
import json
import os
from pathlib import Path

import pytest
import torch

from circuits_tpu.r1cs import audit as jaudit
from circuits_tpu.tools import cli as jcli
from circuits_tpu_torch.r1cs import audit
from circuits_tpu_torch.tools import cli

from torch_compare import reference_tree

PARAMS = ["4", "16", "4", "2"]  # nTx nLevels maxL1Tx maxFeeTx
CPU = ["--device", "cpu"]


def _call(main, argv, capsys):
    """(exit code, stdout) of one CLI call; a verb that returns exits 0."""
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    (base / "port").mkdir()
    (base / "jax").mkdir()
    return base / "port", base / "jax"


def _run_verbs(main, d, extra):
    """Every verb but audit and compile in directory `d`; returns
    {verb: (exit code, stdout)}. `extra` goes after the engine verbs'
    arguments."""
    res = {}
    old = os.getcwd()
    os.chdir(d)
    try:
        def call(key, argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                try:
                    main(argv)
                    code = 0
                except SystemExit as e:
                    code = e.code
            res[key] = (code, buf.getvalue())

        call("create", ["create"] + PARAMS)
        call("input", ["input", "4", "2"] + PARAMS)
        inp = d / "inputs-4.json"
        bad = json.loads(inp.read_text())
        bad["balance1"][0] = str(int(bad["balance1"][0]) + 7)
        (d / "bad.json").write_text(json.dumps(bad))
        call("witness", ["witness", str(inp), str(d / "out.json")]
             + PARAMS + extra)
        call("check", ["check", str(inp)] + PARAMS + extra)
        call("check_bad", ["check", str(d / "bad.json")] + PARAMS + extra)
        call("trace_one", ["trace", str(inp)] + PARAMS
             + ["decode.tokenID"] + extra)
        call("trace", ["trace", str(inp)] + PARAMS + extra)
        call("witnessfull", ["witnessfull", str(inp), str(d / "full.wtns")]
             + PARAMS + extra)
        call("zkey", ["zkey"])
    finally:
        os.chdir(old)
    return res


@pytest.fixture(scope="module")
def runs(dirs):
    port, jax_dir = dirs
    return _run_verbs(cli.main, port, CPU), _run_verbs(jcli.main, jax_dir, [])


def test_create_writes_the_same_config(dirs, runs):
    port, jax_dir = dirs
    rel = Path("rollup-4-16-4-2") / "config.json"
    assert (port / rel).read_bytes() == (jax_dir / rel).read_bytes()
    assert runs[0]["create"] == runs[1]["create"]


def test_input_writes_the_same_bytes_and_hash(dirs, runs):
    port, jax_dir = dirs
    assert (port / "inputs-4.json").read_bytes() == \
        (jax_dir / "inputs-4.json").read_bytes()
    assert runs[0]["input"] == runs[1]["input"]
    assert "expected hashGlobalInputs = " in runs[0]["input"][1]


def test_witness_writes_the_same_outputs(dirs, runs):
    port, jax_dir = dirs
    got = json.loads((port / "out.json").read_text())
    want = json.loads((jax_dir / "out.json").read_text())
    for d in (got, want):
        assert isinstance(d.pop("witnessTimeSeconds"), float)
    assert got == want
    assert got["ok"] is True
    expected = runs[0]["input"][1].strip().rsplit("= ", 1)[1].rstrip(")")
    assert got["outputs"]["hash_global_inputs"] == expected
    for r in runs:
        assert r["witness"][0] == 0
        assert r["witness"][1].split("ok=")[1] == \
            runs[1]["witness"][1].split("ok=")[1]


def test_check_exit_codes(runs):
    port, jax_side = runs
    assert port["check"] == jax_side["check"] == (0, "constraints SATISFIED\n")
    assert port["check_bad"] == jax_side["check_bad"] == \
        (1, "constraints FAILED\n")


def test_trace_prints_the_same_json(runs):
    port, jax_side = runs
    for key in ("trace", "trace_one"):
        assert port[key][0] == jax_side[key][0] == 0
        assert json.loads(port[key][1]) == json.loads(jax_side[key][1]), key
    assert json.loads(port["trace_one"][1]) == \
        {"decode.tokenID": ["1", "1", "0", "0"]}


def test_witnessfull_writes_the_same_bytes(dirs, runs):
    port, jax_dir = dirs
    for name in ("full.wtns", "full.wtns.sym.json"):
        assert (port / name).read_bytes() == (jax_dir / name).read_bytes()
    assert runs[0]["witnessfull"][0] == runs[1]["witnessfull"][0] == 0
    assert "ALL SATISFIED" in runs[0]["witnessfull"][1]
    # the same lines but for the seconds of the export
    strip = [line.split(" signals, ")[0] if " signals, " in line else line
             for line in runs[0]["witnessfull"][1].splitlines()]
    want = [line.split(" signals, ")[0] if " signals, " in line else line
            for line in runs[1]["witnessfull"][1].splitlines()]
    assert [s.replace(str(dirs[0]), "") for s in strip] == \
        [s.replace(str(dirs[1]), "") for s in want]


def test_zkey_is_out_of_scope_on_both(runs):
    assert runs[0]["zkey"] == runs[1]["zkey"]
    assert "out of scope" in str(runs[0]["zkey"][0])


def test_audit_prints_what_the_jax_cli_prints(tmp_path, monkeypatch,
                                              capsys):
    tree = reference_tree(tmp_path / "src", jaudit.MANIFEST)
    for root, verdict in ((tree, "audit: OK"),
                          (tmp_path / "absent", "audit: FAILED")):
        for mod in (audit, jaudit):
            monkeypatch.setattr(mod, "REF_SRC", root)
        code, out = _call(cli.main, ["audit"], capsys)
        assert (code, out) == _call(jcli.main, ["audit"], capsys)
        assert code == 0 and verdict in out, out


def test_compile_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for verb in ("compile", "compilewitness"):
        code, out = _call(cli.main, [verb] + PARAMS + CPU, capsys)
        assert code == 0, out
        lines = out.strip().splitlines()
        assert lines[0] == "no kernel library on cpu: the plain versions run"
        assert lines[1].startswith("compiled RollupMain(4,16,4,2) in ")
        assert lines[1].endswith(" reference constraints")


@pytest.mark.parametrize("verb", ["witness", "check", "trace", "compile"])
def test_engine_verb_without_device_asks_for_the_card(tmp_path, capsys,
                                                      monkeypatch, verb):
    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without a card")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.json").write_text("{}")
    args = {"witness": ["in.json", "out.json"], "check": ["in.json"],
            "trace": ["in.json"], "compile": []}[verb]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main([verb] + args + PARAMS)
    assert not (tmp_path / "out.json").exists()
