"""Batched BabyJubJub point arithmetic + EdDSA-Poseidon verification.

Port of `circuits_tpu/ops/babyjubjub.py` (circomlib EdDSAPoseidonVerifier,
Bits2Point_Strict). Points are projective (X : Y : Z), coordinates in
Montgomery form, each (16, *batch). The group check S * B8 == R8 + hm * A
runs in `eddsa_ok_mont`, the wrapper of kernel K3 (csrc/eddsa.cu), whose
plain version `eddsa_ok_mont_plain` uses the same algorithm and formulas:
fixed-base comb over the host table, windowed variable-base Horner.

S is read as 253 bits, as circomlib's Num2Bits(253) does and as the JAX
package's XLA path does (its Pallas kernel reads 256; see ROADMAP F2).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..convert import comb_table, limbs_to_words
from ..field import fr
from ..host import babyjub
from .poseidon import poseidon

N_LIMBS = fr.N_LIMBS
S_BITS = 253


@lru_cache(maxsize=None)
def _comb(device: torch.device, words: bool) -> torch.Tensor:
    """The comb table on `device`: (64, 16, 2, 16) int64 limbs, or
    (64, 16, 2, 8) int32-stored 32-bit words for the kernel."""
    tab = comb_table()
    if words:
        w = limbs_to_words(tab)  # (64, 16, 2, 8) uint32
        return torch.from_numpy(w.view(np.int32).copy()).to(device)
    return torch.from_numpy(tab.astype(np.int64)).to(device)


def _mm_batch(pairs):
    """Several independent Montgomery products as one batched mont_mul."""
    shape = torch.broadcast_shapes(*[x.shape for p in pairs for x in p])
    a = torch.cat([p[0].expand(shape) for p in pairs], dim=-1)
    b = torch.cat([p[1].expand(shape) for p in pairs], dim=-1)
    return fr.mont_mul(a, b).split(shape[-1], dim=-1)


def _padd_core(p1, x2, y2, az):
    """Unified add (add-2008-bbjlp) given az = z1 * z2 (z1 for an affine
    second point): the 13 / 12 products of the kernel's `padd` /
    `padd_affine`, in 5 batched stages."""
    x1, y1, _ = p1
    ref = x1
    bb, c, d, t = _mm_batch([(az, az), (x1, x2), (y1, y2),
                             (fr.add(x1, y1), fr.add(x2, y2))])
    cd, ac = _mm_batch([(c, d), (fr.mont_const(babyjub.A, ref), c)])
    e = fr.mont_mul(cd, fr.mont_const(babyjub.D, ref))
    f = fr.sub(bb, e)
    g = fr.add(bb, e)
    u = fr.sub(fr.sub(t, c), d)
    v = fr.sub(d, ac)
    af, ag, z3 = _mm_batch([(az, f), (az, g), (f, g)])
    x3, y3 = _mm_batch([(af, u), (ag, v)])
    return (x3, y3, z3)


def padd(p1, p2):
    return _padd_core(p1, p2[0], p2[1], fr.mont_mul(p1[2], p2[2]))


def padd_affine(p1, q):
    return _padd_core(p1, q[0], q[1], p1[2])


def pdouble(p):
    """dbl-2008-bbjlp, 8 products."""
    x, y, z = p
    xy = fr.add(x, y)
    b, c, d, h = _mm_batch([(xy, xy), (x, x), (y, y), (z, z)])
    e = fr.mont_mul(c, fr.mont_const(babyjub.A, x))
    f = fr.add(e, d)
    j = fr.sub(fr.sub(f, h), h)
    x3, y3, z3 = _mm_batch([(fr.sub(fr.sub(b, c), d), j),
                            (f, fr.sub(e, d)), (f, j)])
    return (x3, y3, z3)


def _digits(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Canonical (16, B) -> (64, B) radix-16 digits of its low `nbits`
    bits, least significant first."""
    bits = fr.bits_le(x, nbits)
    if nbits < 256:
        bits = torch.cat([bits, bits.new_zeros((256 - nbits,) + bits.shape[1:])])
    w = torch.tensor([1, 2, 4, 8], dtype=torch.int64, device=x.device)
    return (bits.reshape((64, 4) + bits.shape[1:])
            * w.reshape((1, 4) + (1,) * (bits.dim() - 1))).sum(dim=1)


def _gather_points(table, digit):
    """table: coords (16, 16 entries, B); digit (B,) -> coords (16, B)."""
    idx = digit.reshape(1, 1, -1).expand(N_LIMBS, 1, -1)
    return tuple(torch.gather(c, 1, idx)[:, 0] for c in table)


def eddsa_ok_mont_plain(ax_m, ay_m, s, r8x_m, r8y_m, hm):
    """S * B8 == R8 + hm * A per lane, plain PyTorch. Coordinates
    Montgomery affine, s / hm canonical, all (16, B). Returns (B,) bool."""
    b = ax_m.shape[-1]
    dev = ax_m.device
    one = fr.mont_const(1, ax_m).expand(ax_m.shape)
    zero = torch.zeros_like(ax_m)
    ident = (zero, one, one)
    # 16-entry table of d * A: T[0] = identity, T[1] = A, T[d] = T[d-1] + A
    tab = [ident, (ax_m, ay_m, one)]
    for _ in range(2, 16):
        tab.append(padd_affine(tab[-1], (ax_m, ay_m)))
    tab = tuple(torch.stack([p[k] for p in tab], dim=1) for k in range(3))
    d_hm = _digits(hm, 254)
    d_s = _digits(s, S_BITS)
    comb = _comb(dev, False)  # (64, 16, 2, 16)
    var, fix = ident, ident
    for jj in range(63, -1, -1):
        for _ in range(4):
            var = pdouble(var)
        # var += T[d_hm]  and  fix += TAB[jj][d_s]  (affine, z = 1) as one
        # batched add: padd with z2 = 1 computes padd_affine exactly
        q = _gather_points(tab, d_hm[jj])
        sel = comb[jj][d_s[jj]]  # (B, 2, 16)
        px, py = sel[:, 0].T, sel[:, 1].T
        both = padd(tuple(torch.cat([v, f], dim=-1) for v, f in zip(var, fix)),
                    tuple(torch.cat([a, c], dim=-1)
                          for a, c in zip(q, (px, py, one))))
        var = tuple(c[:, :b] for c in both)
        fix = tuple(c[:, b:] for c in both)
    rx, ry, rz = padd_affine(var, (r8x_m, r8y_m))
    fx, fy, fz = fix
    l1, l2, l3, l4 = _mm_batch([(fx, rz), (rx, fz), (fy, rz), (ry, fz)])
    return fr.eq(l1, l2) & fr.eq(l3, l4)


def eddsa_ok_mont(ax_m, ay_m, s, r8x_m, r8y_m, hm):
    """Wrapper of kernel K3; arguments as `eddsa_ok_mont_plain`."""
    dev = ax_m.device
    if dev.type == "cpu":
        return eddsa_ok_mont_plain(ax_m, ay_m, s, r8x_m, r8y_m, hm)
    if dev.type != "cuda":
        raise ValueError(f"eddsa_ok_mont: unsupported device {dev}")
    b = ax_m.shape[-1]
    args = dict(ax_m=ax_m, ay_m=ay_m, s=s, r8x_m=r8x_m, r8y_m=r8y_m, hm=hm)
    for name, x in args.items():
        kernels.require(x, name, torch.int64, (N_LIMBS, b), dev)
    comb = _comb(dev, True)
    so = kernels.prepare(dev)
    ok = torch.empty((b,), dtype=torch.uint8, device=dev)
    kernels.launch("eddsa_check", so.ctpu_eddsa_check(
        *(kernels.ptr(x) for x in args.values()), kernels.ptr(comb),
        kernels.ptr(ok), b, kernels.stream_ptr(dev)))
    return ok.bool()


def ay_sign_to_ax(ay, sign):
    """Batched AySign2Ax: recover x from y and the sign bit. Returns
    (ax canonical, on_curve (batch,) bool)."""
    ym = fr.to_mont(ay)
    y2m = fr.mont_mul(ym, ym)
    one_m = fr.mont_const(1, ay).expand(ay.shape)
    num_m = fr.sub(one_m, y2m)
    den_m = fr.sub(fr.mont_const(babyjub.A, ay).expand(ay.shape),
                   fr.mont_mul(fr.mont_const(babyjub.D, ay), y2m))
    den_zero = fr.is_zero(den_m)
    safe_m = fr.select(den_zero, one_m, den_m)
    inv_m = fr._pow_const_mont(safe_m, fr.P - 2)
    x2 = fr.from_mont(fr.mont_mul(num_m, inv_m))
    root, ok = fr.sqrt(x2)
    ax = fr.select(sign, fr.neg(root), root)
    return ax, ok & ~den_zero


def eddsa_poseidon_verify(enabled, ax, ay, s, r8x, r8y, msg):
    """Batched circomlib EdDSAPoseidonVerifier: S * B8 == R8 +
    Poseidon(R8x, R8y, Ax, Ay, M) * A where enabled. Field inputs
    canonical (16, B). Returns ok (B,) bool (True where disabled)."""
    hm = poseidon([r8x, r8y, ax, ay, msg])
    n = ax.shape[-1]
    coords = fr.to_mont(torch.cat([ax, ay, r8x, r8y], dim=-1))
    ax_m, ay_m, r8x_m, r8y_m = (c.contiguous() for c in coords.split(n, -1))
    okp = eddsa_ok_mont(ax_m, ay_m, s.contiguous(), r8x_m, r8y_m,
                        hm.contiguous())
    return okp | ~enabled.bool()
