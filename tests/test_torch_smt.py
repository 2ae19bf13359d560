"""The port's SMT processor (K2's plain version on the CPU) against the JAX
package's `processor` and the host tree, on INSERT (with push-down),
UPDATE, DELETE, NOP and isOld0 lanes, plus a bad proof. Exact."""

import random

import jax
import numpy as np
import pytest
import torch

from circuits_tpu.builder.smt import SMT
from circuits_tpu.field import fr as jfr
from circuits_tpu.field.scalar import P
from circuits_tpu.ops import smt as jsmt
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.ops import smt

from torch_compare import assert_same, to_torch

NL = 9


def _pad(s):
    return s + [0] * (NL - len(s))


def _args(ops):
    return dict(
        old_root=jfr.pack_np([o["old_root"] for o in ops]),
        siblings=np.moveaxis(jfr.pack_np([_pad(o["siblings"]) for o in ops]),
                             2, 0),
        old_key=jfr.pack_np([o["old_key"] for o in ops]),
        old_value=jfr.pack_np([o["old_value"] for o in ops]),
        is_old0=np.array([int(o["is_old0"]) for o in ops], np.uint32),
        new_key=jfr.pack_np([o["new_key"] for o in ops]),
        new_value=jfr.pack_np([o["new_value"] for o in ops]),
        fnc0=np.array([o["fnc"][0] for o in ops], np.uint32),
        fnc1=np.array([o["fnc"][1] for o in ops], np.uint32),
    )


def _ops():
    rng = random.Random(555)
    t = SMT()
    ops = []
    # INSERT: the first into an empty tree (isOld0), then push-downs
    for k in (1, 5, 3, 2, 9, 12, 30, 17, 100, 64):
        pr = t.insert(k, k * 1000 + 7)
        pr["fnc"] = (1, 0)
        ops.append(pr)
    for k in (5, 30, 64):
        pr = t.update(k, rng.randrange(P))
        pr["fnc"] = (0, 1)
        ops.append(pr)
    for k in (2, 100, 9):
        pr = t.delete(k)
        pr["fnc"] = (1, 1)
        pr["new_key"] = pr.pop("del_key")
        pr["new_value"] = pr.pop("del_value")
        ops.append(pr)
    ops.append(dict(old_root=t.root, siblings=[123] + [0] * (NL - 1),
                    old_key=99, old_value=98, is_old0=False, new_key=97,
                    new_value=96, fnc=(0, 0), new_root=t.root))
    bad = dict(ops[4])
    bad["old_root"] = (bad["old_root"] + 1) % P
    ops.append(bad)
    return ops


@pytest.fixture(scope="module")
def cases():
    ops = _ops()
    args = _args(ops)
    want = jax.jit(jsmt.processor)(**args)
    got = smt.processor(**{k: to_torch(v) for k, v in args.items()})
    return ops, got, want


def test_processor_matches_jax(cases):
    _, got, want = cases
    assert_same(got[0], want[0], "new_root")
    assert_same(got[1], want[1], "ok")


@pytest.mark.parametrize("kind", ["insert", "update", "delete", "nop"])
def test_processor_matches_host_tree(cases, kind):
    ops, got, _ = cases
    sel = {"insert": range(0, 10), "update": range(10, 13),
           "delete": range(13, 16), "nop": range(16, 17)}[kind]
    roots = [int(v) for v in fr.unpack_np(got[0])]
    for i in sel:
        assert bool(got[1][i]), (kind, i)
        assert roots[i] == ops[i]["new_root"], (kind, i)


def test_bad_proof_flags_and_first_insert_is_old0(cases):
    ops, got, _ = cases
    assert ops[0]["is_old0"]
    assert not bool(got[1][-1])


def test_chain_plain_equals_wrapper_on_cpu(cases):
    ops = cases[0]
    args = {k: to_torch(v) for k, v in _args(ops).items()}
    del args["old_root"]
    cargs = smt.chain_args(**args)
    assert_same(smt.processor_chain(*cargs),
                smt.processor_chain_plain(*cargs))


def test_chain_plain_equals_jax_chain(cases):
    """`processor_chain_plain` on the port's chain arguments == the JAX
    package's level-by-level chain (`jsmt.processor_chains`, the XLA scan
    that the Pallas kernel is held against), lane for lane."""
    ops = cases[0]
    args = _args(ops)
    del args["old_root"]
    targs = {k: to_torch(v) for k, v in args.items()}
    old, new = smt.processor_chain_plain(*smt.chain_args(**targs))
    want_old, want_new, _ = jax.jit(jsmt.processor_chains)(**args)
    f_delete = to_torch(args["fnc0"]).bool() & to_torch(args["fnc1"]).bool()
    # processor_chains swaps the two chains on DELETE lanes
    assert_same(fr.select(f_delete, new, old), want_old, "old")
    assert_same(fr.select(f_delete, old, new), want_new, "new")


@pytest.mark.parametrize("lanes", [1, 33])
def test_processor_at_ragged_lane_counts(cases, lanes):
    """1 and 33 lanes (no multiple of the kernel's 4 lanes a warp): the
    wrapper on the CPU against the host tree's roots."""
    ops = [cases[0][i % 17] for i in range(lanes)]
    args = {k: to_torch(v) for k, v in _args(ops).items()}
    new_root, ok = smt.processor(**args)
    assert bool(ok.all())
    assert [int(v) for v in fr.unpack_np(new_root)] == \
        [o["new_root"] for o in ops]


def test_wrapper_refuses_other_devices():
    meta = dict(dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        smt.processor_chain(torch.zeros((3, 16, 2), **meta),
                            torch.zeros((3, 2), **meta),
                            torch.zeros((3, 5, 2), **meta),
                            *(torch.zeros((16, 2), **meta),) * 3)


def _k2_mirror(sib_f, bits_f, masks_f, old1leaf, new1leaf, new1h):
    """K2's level loop as csrc/smt.cu walks it. Eight threads a lane make
    4 lanes a warp; a level is hashed for a warp's lanes only where some
    lane of the warp has `top` or `bot` (the warp vote), and its hashes are
    zeros otherwise; a dead lane at the ragged end walks lane B - 1 again
    and stores nothing. The two hashes a lane: group 0 the old chain, group
    1 the bottom pair under `bot` and the new chain otherwise. Returns
    (old, new, the (warp, level) pairs hashed and skipped, per level)."""
    n, _, b = sib_f.shape
    warps = -(-b // 4)
    idx = torch.tensor([min(lane, b - 1) for lane in range(4 * warps)])
    sib, bits, masks = sib_f[:, :, idx], bits_f[:, idx], masks_f[:, :, idx]
    old1, new1, n1h = old1leaf[:, idx], new1leaf[:, idx], new1h[:, idx]
    zero = torch.zeros_like(old1)
    oldc = newc = zero
    hashed, skipped = [], []
    for lvl in range(n):
        top, old0, bot, new1m, upd = (masks[lvl, j].bool() for j in range(5))
        vote = (top | bot).reshape(warps, 4).any(dim=1)
        hashed.append({w for w in range(warps) if vote[w]})
        skipped.append({w for w in range(warps) if not vote[w]})
        oh, xh = zero.clone(), zero.clone()
        lanes = vote.repeat_interleave(4).nonzero().flatten()
        if len(lanes):
            bit, s = bits[lvl, lanes].bool(), sib[lvl][:, lanes]
            oc, nc = oldc[:, lanes], newc[:, lanes]
            s1 = fr.select(bot[lanes], zero[:, lanes], s)
            h = smt._hash0_plain(
                torch.cat([fr.select(bit, s, oc), fr.select(bit, s1, nc)], 1),
                torch.cat([fr.select(bit, oc, s), fr.select(bit, nc, s1)], 1))
            oh[:, lanes], xh[:, lanes] = h[:, :len(lanes)], h[:, len(lanes):]
        old_up = fr.select(top, oh, zero)
        old_up = fr.select(bot | new1m | upd, old1, old_up)
        new_up = fr.select(top | bot, xh, zero)
        new_up = fr.select(new1m, n1h, new_up)
        new_up = fr.select(old0 | upd, new1, new_up)
        oldc, newc = old_up, new_up
    return oldc[:, :b], newc[:, :b], hashed, skipped


@pytest.mark.parametrize("lanes", [17, 30])
def test_k2_warp_vote_mirror_equals_plain(cases, lanes):
    """The mirror of K2's warp-vote level skip == `processor_chain_plain`
    at lane counts that are not a multiple of 4 (a ragged last warp), on
    warps whose lanes act at different levels, where some warps skip a
    level that others hash."""
    ops = [cases[0][(7 * i) % 17] for i in range(lanes)]
    args = {k: to_torch(v) for k, v in _args(ops).items()}
    del args["old_root"]
    cargs = smt.chain_args(**args)
    old, new, hashed, skipped = _k2_mirror(*cargs)
    want_old, want_new = smt.processor_chain_plain(*cargs)
    assert_same(old, want_old, "old")
    assert_same(new, want_new, "new")
    masks = cargs[2]
    act = (masks[:, 0] | masks[:, 2]).bool()  # (levels, lanes)
    # the lowest level at which each lane hashes: several in one warp
    first = [int(act[:, i].nonzero()[0]) if act[:, i].any() else -1
             for i in range(lanes)]
    assert any(len(set(first[w:w + 4])) > 1 for w in range(0, lanes, 4))
    assert any(h and s for h, s in zip(hashed, skipped))
    assert sum(map(len, skipped)) > 0 and sum(map(len, hashed)) > 0
