"""Batched BabyJubJub point arithmetic + EdDSA-Poseidon verification.

Port of `circuits_tpu/ops/babyjubjub.py` (circomlib EdDSAPoseidonVerifier,
Bits2Point_Strict). Points are projective (X : Y : Z), coordinates in
Montgomery form, each (16, *batch). The group check S * B8 == R8 + hm * A
runs in `eddsa_ok_mont`, the wrapper of kernel K3 (csrc/eddsa.cu), whose
plain version `eddsa_ok_mont_plain` uses the same algorithm: fixed-base
comb over the host table, windowed variable-base Horner. The kernel walks
the curve in its a = 1 form (x scaled by sqrt(a)), where every Y and Z is
the plain version's and every X is sqrt(a) times it; the verdict is the same.
Bits2Point_Strict's x from y and the sign runs in `ay_sign_to_ax`, the
wrapper of the AySign2Ax kernel (csrc/ay_sign.cu), one thread a lane, whose
plain version `ay_sign_to_ax_plain` takes the same steps.

The module's public point operations (`identity`, `from_affine_mont`,
`pselect`, `points_equal`, `scalar_mul_var`, `scalar_mul_base8`) are plain
PyTorch with the JAX package's order of additions, so their projective
limbs equal the JAX functions'. They are not a second EdDSA route.

S is read as 253 bits, as circomlib's Num2Bits(253) does and as the JAX
package's XLA path does (its Pallas kernel reads 256; see ROADMAP F2).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..convert import comb_table, eddsa_kernel_words
from ..field import fr
from ..builder import babyjub
from .poseidon import poseidon

N_LIMBS = fr.N_LIMBS
S_BITS = 253


@lru_cache(maxsize=None)
def _comb(device: torch.device, words: bool) -> torch.Tensor:
    """The comb table on `device`: (64, 16, 2, 16) int64 limbs for the
    plain version, or the kernel's constant block
    (`convert.eddsa_kernel_words`) as int32-stored 32-bit words."""
    if words:
        w = eddsa_kernel_words()  # (64 * 16 * 3 + 2, 8) uint32
        return torch.from_numpy(w.view(np.int32).copy()).to(device)
    return torch.from_numpy(comb_table().astype(np.int64)).to(device)


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


def identity(bshape, device=None):
    """Projective identity (0 : 1 : 1), Montgomery form."""
    zero = fr.zeros(bshape, device)
    one = fr.mont_const(1, zero).expand(zero.shape)
    return (zero, one, one)


def from_affine_mont(x_m, y_m):
    return (x_m, y_m, fr.mont_const(1, x_m).expand(x_m.shape))


def pselect(cond, p1, p2):
    return tuple(fr.select(cond, u, v) for u, v in zip(p1, p2))


def points_equal(p1, p2):
    """Projective equality X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1; (batch,)
    bool."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    a, b, c, d = _mm_batch([(x1, z2), (x2, z1), (y1, z2), (y2, z1)])
    return fr.eq(a, b) & fr.eq(c, d)


def _pad_identity(x, y, z, m):
    """Pad the point axis (dim 1) to m with projective identities."""
    n = x.shape[1]
    if m == n:
        return (x, y, z)
    shape = x.shape[:1] + (m - n,) + x.shape[2:]
    one = fr.mont_const(1, x).expand(shape)
    return (torch.cat([x, x.new_zeros(shape)], dim=1),
            torch.cat([y, one], dim=1), torch.cat([z, one], dim=1))


def _sum_points(pts, segments=8):
    """Sum N projective points (coords (16, N, *batch)) in the JAX
    package's order: S = min(segments, N) chains, chain i adding points
    i k .. i k + k - 1 (k = ceil(N / S), identities pad the tail), one
    padd a step for the S chains at once; then the S partial sums folded
    left to right from the identity."""
    n = pts[0].shape[1]
    bshape = pts[0].shape[2:]
    s = min(segments, n)
    k = -(-n // s)
    seg = tuple(c.reshape((N_LIMBS, s, k) + bshape)
                for c in _pad_identity(*pts, s * k))
    acc = identity((s,) + bshape, pts[0].device)
    for j in range(k):
        acc = padd(acc, tuple(c[:, :, j] for c in seg))
    total = identity(bshape, pts[0].device)
    for i in range(s):
        total = padd(total, tuple(c[:, i] for c in acc))
    return total


def _var_points(bits, point):
    """Masked point stack for a variable-base multiply: coords
    (16, nbits, *batch), entry i = bit_i ? 2^i * point : identity
    ((0 : Z : Z) is the identity)."""
    rows = [point]
    for _ in range(bits.shape[0] - 1):
        rows.append(pdouble(rows[-1]))
    dx, dy, dz = (torch.stack([r[k] for r in rows], dim=1) for k in range(3))
    bb = bits.bool().unsqueeze(0)
    return (torch.where(bb, dx, 0), torch.where(bb, dy, dz), dz)


def scalar_mul_var(bits, point):
    """Variable-base scalar multiply: bits (nbits, *batch) 0/1 LSB-first,
    point projective Montgomery; sum over the set bits of 2^i * point."""
    return _sum_points(_var_points(bits, point))


def _base8_points(bits):
    """Comb-selected point stack for the fixed-base multiply by BASE8:
    coords (16, 64, *batch), entry j = digit_j * 16^j * BASE8 from the comb
    table (`_comb`, the JAX package's `_base8_window_table`)."""
    bshape = bits.shape[1:]
    digits = _digits(bits)  # (64, *batch)
    tab = _comb(bits.device, False).reshape(64 * 16, 2, N_LIMBS)
    offs = (torch.arange(64, device=bits.device) * 16).reshape(
        (64,) + (1,) * len(bshape))
    sel = tab[digits + offs]  # (64, *batch, 2, 16)
    px = sel[..., 0, :].movedim(-1, 0)
    py = sel[..., 1, :].movedim(-1, 0)
    return (px, py, fr.mont_const(1, px).expand(px.shape))


def scalar_mul_base8(bits):
    """Fixed-base multiply by BASE8: comb table, then the segmented sum."""
    return _sum_points(_base8_points(bits))


@lru_cache(maxsize=None)
def _digit_weights(ndim: int, device: torch.device) -> torch.Tensor:
    """(1, 4, 1, ...) weights 1, 2, 4, 8 of a radix-16 digit's bits over
    `ndim` batch axes, on `device`; built once, only read."""
    w = torch.tensor([1, 2, 4, 8], dtype=torch.int64, device=device)
    return w.reshape((1, 4) + (1,) * ndim)


def _digits(bits: torch.Tensor) -> torch.Tensor:
    """bits (nbits, *batch) 0/1 LSB-first -> (64, *batch) int64 radix-16
    digits, least significant first."""
    bshape = bits.shape[1:]
    if bits.shape[0] < 256:
        bits = torch.cat([bits, bits.new_zeros((256 - bits.shape[0],) + bshape)])
    w = _digit_weights(len(bshape), bits.device)
    return (bits.to(torch.int64).reshape((64, 4) + bshape) * w).sum(dim=1)


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
    d_hm = _digits(fr.bits_le(hm, 254))
    d_s = _digits(fr.bits_le(s, S_BITS))
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


def ay_sign_to_ax_plain(ay, sign):
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


def ay_sign_to_ax(ay, sign):
    """Wrapper of the AySign2Ax kernel (csrc/ay_sign.cu): ay canonical
    (16, B) int64, sign (B,) bool; results as `ay_sign_to_ax_plain`."""
    dev = ay.device
    b = ay.shape[-1]
    kernels.require(ay, "ay", torch.int64, (N_LIMBS, b), dev)
    kernels.require(sign, "sign", torch.bool, (b,), dev)
    if dev.type == "cpu":
        return ay_sign_to_ax_plain(ay, sign)
    if dev.type != "cuda":
        raise ValueError(f"ay_sign_to_ax: unsupported device {dev}")
    so = kernels.prepare(dev)
    ax = torch.empty((N_LIMBS, b), dtype=torch.int64, device=dev)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    kernels.launch("ay_sign_to_ax", so.ctpu_ay_sign_to_ax(
        kernels.ptr(ay), kernels.ptr(sign), kernels.ptr(ax), kernels.ptr(ok),
        b, kernels.stream_ptr(dev)))
    return ax, ok


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
