"""Batched SMT processor and verifier (circomlib smtprocessor.circom and
smtverifier.circom semantics).

Port of `circuits_tpu/ops/smt.py`: the top-down state machine
(top / old0 / bot / new1 / upd) and the leaf hashes stay here; the
bottom-up hash chains run in `processor_chain`, the wrapper of kernel K2
(csrc/smt.cu), whose plain version is `processor_chain_plain`. Both hash
with the sparse Poseidon schedule and take a level's hashes only where a
mask can select them. `verifier` hashes its one chain level by level
through `poseidon` (kernel K1).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..field import fr
from .poseidon import permute_mont_plain, poseidon

N_LIMBS = fr.N_LIMBS


def smt_hash0(l, r):
    return poseidon([l, r])


def smt_hash1(k, v):
    return poseidon([k, v, fr.const(1, k.shape[1:], k.device).expand(k.shape)])


def _lev_ins(siblings):
    """siblings (n, 16, B) -> levIns (n, B) bool: all siblings j >= i are
    zero and (i == 0 or sibling[i-1] != 0)."""
    isz = (siblings == 0).all(dim=1)  # (n, B)
    suffix_all_zero = torch.flip(torch.cumprod(
        torch.flip(isz.long(), dims=[0]), dim=0), dims=[0]).bool()
    prev_nonzero = torch.cat([torch.ones_like(isz[:1]), ~isz[:-1]], dim=0)
    return suffix_all_zero & prev_nonzero


def _hash0_plain(l, r):
    """Poseidon(2) through the plain permutation (canonical (16, B))."""
    state = fr.to_mont(torch.stack([torch.zeros_like(l), l, r], dim=1))
    return fr.from_mont(permute_mont_plain(state)[:, 0])


def processor_chain_plain(sib_f, bits_f, masks_f, old1leaf, new1leaf, new1h):
    """Bottom-up SMT hash chains, plain PyTorch. sib_f (n, 16, B), bits_f
    (n, B) 0/1, masks_f (n, 5, B) 0/1 (top/old0/bot/new1/upd), all flipped
    bottom-up; old1leaf/new1leaf/new1h (16, B). Returns (old, new)."""
    n, _, b = sib_f.shape
    zero = torch.zeros_like(old1leaf)
    oldc, newc = zero, zero
    for i in range(n):
        sib, bit = sib_f[i], bits_f[i]
        top, old0, bot, new1m, upd = (masks_f[i, j].bool() for j in range(5))
        # a hash is taken only at levels where some lane can select it
        # (old/new chain: `top`, bottom pair: `bot`), as in the kernel
        oh = nh = bh = zero
        if bool(top.any()):
            h = _hash0_plain(
                torch.cat([fr.select(bit, sib, oldc),
                           fr.select(bit, sib, newc)], dim=1),
                torch.cat([fr.select(bit, oldc, sib),
                           fr.select(bit, newc, sib)], dim=1))
            oh, nh = h[:, :b], h[:, b:]
        if bool(bot.any()):
            bh = _hash0_plain(fr.select(bit, zero, newc),
                              fr.select(bit, newc, zero))
        old_up = fr.select(top, oh, zero)
        old_up = fr.select(bot | new1m | upd, old1leaf, old_up)
        new_up = fr.select(top, nh, zero)
        new_up = fr.select(bot, bh, new_up)
        new_up = fr.select(new1m, new1h, new_up)
        new_up = fr.select(old0 | upd, new1leaf, new_up)
        oldc, newc = old_up, new_up
    return oldc, newc


def processor_chain(sib_f, bits_f, masks_f, old1leaf, new1leaf, new1h):
    """Wrapper of kernel K2; arguments as `processor_chain_plain`."""
    dev = sib_f.device
    if dev.type == "cpu":
        return processor_chain_plain(sib_f, bits_f, masks_f, old1leaf,
                                     new1leaf, new1h)
    if dev.type != "cuda":
        raise ValueError(f"processor_chain: unsupported device {dev}")
    n, _, b = sib_f.shape
    bits_u8 = bits_f.to(torch.uint8).contiguous()
    masks_u8 = masks_f.to(torch.uint8).contiguous()
    kernels.require(sib_f, "sib_f", torch.int64, (n, N_LIMBS, b), dev)
    kernels.require(bits_u8, "bits_f", torch.uint8, (n, b), dev)
    kernels.require(masks_u8, "masks_f", torch.uint8, (n, 5, b), dev)
    for name, x in (("old1leaf", old1leaf), ("new1leaf", new1leaf),
                    ("new1h", new1h)):
        kernels.require(x, name, torch.int64, (N_LIMBS, b), dev)
    out = torch.empty((2, N_LIMBS, b), dtype=torch.int64, device=dev)
    if b == 0:
        return out[0], out[1]
    so = kernels.prepare(dev)
    tab = kernels.poseidon_table(dev)
    kernels.launch("smt_chain", so.ctpu_smt_chain(
        kernels.ptr(sib_f), kernels.ptr(bits_u8), kernels.ptr(masks_u8),
        kernels.ptr(old1leaf), kernels.ptr(new1leaf), kernels.ptr(new1h),
        kernels.ptr(out), kernels.ptr(tab), tab.shape[0], n, b,
        kernels.stream_ptr(dev)))
    return out[0], out[1]


def chain_args(siblings, old_key, old_value, is_old0, new_key, new_value,
               fnc0, fnc1):
    """State machine + leaf hashes of SMTProcessor(n): the arguments of
    `processor_chain` for a 1-D lane batch (any other batch shape is
    flattened; the kernel serves 1-D batches)."""
    n = siblings.shape[0]
    bshape = old_key.shape[1:]
    fnc0, fnc1, is0 = fnc0.bool(), fnc1.bool(), is_old0.bool()
    f_update = ~fnc0 & fnc1
    # DELETE runs the insert state machine with the roles swapped
    f_ins_like = fnc0

    lev_ins = _lev_ins(siblings)
    new_bits = fr.bits_le(new_key, n)
    xors = (fr.bits_le(old_key, n) ^ new_bits).bool()

    masks = []
    prev_top = torch.ones(bshape, dtype=torch.bool, device=old_key.device)
    prev_bot = torch.zeros_like(prev_top)
    for i in range(n):
        li = lev_ins[i]
        ins = prev_top & li & ~is0 & f_ins_like
        top = prev_top & ~li
        old0 = prev_top & li & is0 & f_ins_like
        bot = (ins & ~xors[i]) | (prev_bot & ~xors[i])
        new1 = (ins & xors[i]) | (prev_bot & xors[i])
        upd = prev_top & li & f_update
        masks.append(torch.stack([top, old0, bot, new1, upd]))
        prev_top, prev_bot = top, bot
    masks = torch.stack(masks)  # (n, 5, *batch)

    leaf_pair = smt_hash1(torch.cat([old_key, new_key], dim=-1),
                          torch.cat([old_value, new_value], dim=-1))
    old1leaf, new1leaf = leaf_pair.split(bshape[-1], dim=-1)

    # the new1 state holds at most one level per lane: its pair hash is
    # taken once, outside the level chain
    bit_new1 = (masks[:, 3] & new_bits.bool()).any(dim=0)
    new1h = smt_hash0(fr.select(bit_new1, old1leaf, new1leaf),
                      fr.select(bit_new1, new1leaf, old1leaf))

    def lanes(x, lead):
        return x.reshape(lead + (-1,)).contiguous()

    return (lanes(torch.flip(siblings, dims=[0]), (n, N_LIMBS)),
            lanes(torch.flip(new_bits, dims=[0]), (n,)),
            lanes(torch.flip(masks, dims=[0]), (n, 5)),
            lanes(old1leaf, (N_LIMBS,)), lanes(new1leaf, (N_LIMBS,)),
            lanes(new1h, (N_LIMBS,)))


def processor_chains(siblings, old_key, old_value, is_old0,
                     new_key, new_value, fnc0, fnc1):
    """The root-independent part of SMTProcessor(n): state machine + hash
    chains. Returns (computed_old, computed_new, enabled)."""
    old_child, new_child = processor_chain(*chain_args(
        siblings, old_key, old_value, is_old0, new_key, new_value,
        fnc0, fnc1))
    old_child = old_child.reshape(old_key.shape)
    new_child = new_child.reshape(old_key.shape)
    f_delete = fnc0.bool() & fnc1.bool()
    computed_old = fr.select(f_delete, new_child, old_child)
    computed_new = fr.select(f_delete, old_child, new_child)
    return computed_old, computed_new, fnc0.bool() | fnc1.bool()


def processor_check(old_root, computed_old, computed_new, enabled,
                    top_sibling):
    """Root check + output mux. top_sibling: siblings[n-1]."""
    ok = ~enabled | fr.eq(computed_old, old_root)
    ok = ok & (~enabled | fr.is_zero(top_sibling))
    return fr.select(enabled, computed_new, old_root), ok


def processor(old_root, siblings, old_key, old_value, is_old0,
              new_key, new_value, fnc0, fnc1):
    """Batched SMTProcessor(n), n = siblings.shape[0]. Field args (16, B);
    is_old0/fnc0/fnc1 (B,) 0/1. Returns (new_root, ok)."""
    computed_old, computed_new, enabled = processor_chains(
        siblings, old_key, old_value, is_old0, new_key, new_value,
        fnc0, fnc1)
    return processor_check(old_root, computed_old, computed_new, enabled,
                           siblings[siblings.shape[0] - 1])


def verifier_states(siblings):
    """SMTVerifierSM, top-down: (top, at), each (n, B) bool. A lane is
    `top` above its SMTLevIns level and `at` on it, where its leaf sits."""
    lev_ins = _lev_ins(siblings)
    top = ~(torch.cumsum(lev_ins.long(), dim=0) > 0)
    return top, lev_ins


def verifier(enabled, root, siblings, old_key, old_value, is_old0,
             key, value, fnc):
    """Batched SMTVerifier(n) (circomlib smtverifier.circom), n =
    siblings.shape[0]: fnc=0 inclusion proof, fnc=1 exclusion proof. Field
    args (16, B); enabled/is_old0/fnc (B,) 0/1. Returns ok (B,) bool (True
    where disabled). The leaf sits at the SMTLevIns level and is hashed up
    through the levels above it, one Poseidon(2) call a level."""
    n = siblings.shape[0]
    enabled, fnc, is0 = enabled.bool(), fnc.bool(), is_old0.bool()
    zero = torch.zeros_like(root)

    bits = fr.bits_le(key, n)
    leaf_incl = smt_hash1(key, value)
    leaf_excl = smt_hash1(old_key, old_value)
    # exclusion with an empty slot: subtree 0; else the other leaf
    leaf = fr.select(fnc & is0, zero, fr.select(fnc, leaf_excl, leaf_incl))
    tops, ats = verifier_states(siblings)

    child = zero
    for i in range(n - 1, -1, -1):
        h = smt_hash0(fr.select(bits[i], siblings[i], child),
                      fr.select(bits[i], child, siblings[i]))
        child = fr.select(ats[i], leaf, fr.select(tops[i], h, zero))

    ok = fr.eq(child, root)
    # exclusion extra: old_key != key when not isOld0
    ok = ok & (~fnc | is0 | ~fr.eq(old_key, key))
    return ok | ~enabled
