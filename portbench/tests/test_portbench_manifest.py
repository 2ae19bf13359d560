"""BENCHMARK.json against the benchmark's contract: its keys, names,
units, bounds and files; every cell reporting `setup_s`, another
end-to-end metric and a per-layer one; every per-layer metric moving an
end-to-end metric that each of its cells reports; a reader for every
metric; the run length inside the check's budget."""

import json
import re

import pytest

from portbench import harness

REPO = harness.ROOT
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
COUNTS = {"configs": 24, "workloads": 24, "end_to_end": 16,
          "per_layer": 128}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def test_top_level_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", *KEYS}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir() and not p.endswith("_torch")
    for word in cmd[1:]:
        if "/" in word:  # a file of the repo lies under paths
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])


def test_run_seconds_fits_the_budget():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries(group):
    entries = MANIFEST[group]
    assert 1 <= len(entries) <= COUNTS[group]
    for e in entries:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in (
                "lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert line(e[k]), (e["name"], k)


def test_names_unique():
    metrics = [m["name"] for g in ("end_to_end", "per_layer")
               for m in MANIFEST[g]]
    for names in (metrics, [w["name"] for w in MANIFEST["workloads"]],
                  [c["name"] for c in MANIFEST["configs"]]):
        assert len(names) == len(set(names))


def test_configs_and_cells():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        assert (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    pairs = set()
    four = 0
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.fullmatch(w["traffic"])
        assert (REPO / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
    assert len(pairs) == len(MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)


def test_metrics():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell), (
                m["name"], cell)
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in list(e2e.values()) + MANIFEST["per_layer"]:
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_enough():
    for w in MANIFEST["workloads"]:
        names = [m["name"] for m in MANIFEST["end_to_end"]
                 if reports(m, w["name"])]
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert any(reports(m, w["name"]) for m in MANIFEST["per_layer"])


def layer_clashes(manifest: dict) -> list[set]:
    """Layer names that differ only in case or in the characters between
    their words (`engine.witness`, `engine_witness`, `Engine.witness`):
    two spellings of one layer."""
    spellings = {}
    for m in manifest["per_layer"]:
        key = re.sub(r"[^a-z0-9]", "", m["layer"].lower())
        spellings.setdefault(key, set()).add(m["layer"])
    return [names for names in spellings.values() if len(names) > 1]


@pytest.mark.parametrize("layer,clash", [
    (None, False),               # the manifest as it is
    ("engine.export", False),    # a new layer with its metric
    ("engine_witness", True),
    ("Engine.witness", True),
])
def test_layers_named_alike(layer, clash):
    """Metrics of one layer give one name, letter for letter; a new layer
    comes with its metric and needs no edit here."""
    manifest = json.loads(json.dumps(MANIFEST))
    if layer is not None:
        manifest["per_layer"].append(dict(
            manifest["per_layer"][0], name="added.metric", layer=layer))
    assert bool(layer_clashes(manifest)) is clash
