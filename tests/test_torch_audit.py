"""The port's residual audit (`circuits_tpu_torch/r1cs/audit.py`) against
the JAX package's (`circuits_tpu/r1cs/audit.py`): the same sites with the
same kinds, every anchor found in the port's own files (and in K3's
source, where the card decides the EdDSA identity inside the kernel), and
on a stand-in for the reference's circom sources built here
(`torch_compare.reference_tree`) the same parse, verdict, counts and
`report()` text, before and after the tree is edited. Both modules'
`REF_SRC` is patched for the run; neither module is edited."""

import pytest

from circuits_tpu.r1cs import audit as jaudit
from circuits_tpu_torch.r1cs import audit

from torch_compare import reference_tree

ANCHORS = {**{k: (f, a) for k, (kind, f, a) in audit.MANIFEST.items()
              if kind == "residual"},
           **audit.EXTRA_RESIDUALS}


def test_manifest_has_the_jax_sites_kinds_and_order():
    assert list(audit.MANIFEST) == list(jaudit.MANIFEST)
    assert [v[0] for v in audit.MANIFEST.values()] == \
        [v[0] for v in jaudit.MANIFEST.values()]
    assert len(audit.MANIFEST) == 46
    assert list(audit.EXTRA_RESIDUALS) == list(jaudit.EXTRA_RESIDUALS)
    assert set(audit.KERNEL_ANCHORS) <= set(ANCHORS)
    files = [f for _, f, _ in audit.MANIFEST.values()] \
        + [f for f, _ in audit.EXTRA_RESIDUALS.values()] \
        + [f for f, _ in audit.KERNEL_ANCHORS.values()]
    for f in files:
        assert f.startswith("circuits_tpu_torch/"), f
        assert (audit.REPO / f).is_file(), f


def test_every_anchor_is_found_in_the_port():
    assert audit.audit()["bad_anchors"] == []


@pytest.mark.parametrize("key", sorted(ANCHORS) + [
    f"kernel {k}" for k in sorted(audit.KERNEL_ANCHORS)])
def test_each_anchor_names_one_place(key):
    """An anchor stands once in its file, so it names the residual's own
    line and goes when that line goes."""
    table = audit.KERNEL_ANCHORS if key.startswith("kernel ") else ANCHORS
    file, anchor = table[key.removeprefix("kernel ")]
    assert (audit.REPO / file).read_text().count(anchor) == 1, (key, anchor)


def test_a_kernel_anchor_is_checked(monkeypatch):
    name = "circomlib EdDSAPoseidonVerifier identity"
    file, _ = audit.KERNEL_ANCHORS[name]
    monkeypatch.setitem(audit.KERNEL_ANCHORS, name, (file, "no such text"))
    assert audit.audit()["bad_anchors"] == [(name, file, "no such text")]


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """The stand-in source tree, read by both modules."""
    root = reference_tree(tmp_path / "src", jaudit.MANIFEST)
    for mod in (audit, jaudit):
        monkeypatch.setattr(mod, "REF_SRC", root)
    return root


def test_the_stand_in_tree_audits_alike(tree):
    sites = audit.parse_reference_sites()
    assert sites == jaudit.parse_reference_sites()
    assert sorted(sites) == sorted(jaudit.MANIFEST)
    assert "ForceEqualIfEnabled()" in sites["rollup-tx.circom:237"]
    got, want = audit.audit(), jaudit.audit()
    for a in (got, want):
        assert (a["missing_sites"], a["dead_entries"], a["bad_anchors"]) \
            == ([], [], [])
    assert got["counts"] == want["counts"]
    assert (got["n_sites"], got["n_extra"]) == (46, 6)
    text = audit.report()
    assert text == jaudit.report()
    assert "audit: OK missing=[] dead=[] bad_anchors=[]" in text


def test_an_edited_tree_names_the_same_sites(tree):
    path = tree / "decode-tx.circom"
    lines = path.read_text().splitlines()
    lines[354] = "// the constraint at line 355 was deleted"
    lines.append("    extra === site;")
    path.write_text("\n".join(lines) + "\n")
    extra = f"decode-tx.circom:{len(lines)}"
    for mod in (audit, jaudit):
        a = mod.audit()
        assert a["missing_sites"] == [extra]
        assert a["dead_entries"] == ["decode-tx.circom:355"]
    assert audit.report() == jaudit.report()
    assert "audit: FAILED" in audit.report()

