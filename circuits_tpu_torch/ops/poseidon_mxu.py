"""The Poseidon permutation on 8-bit limbs with matrix-product arithmetic.

Port of `circuits_tpu/ops/poseidon_mxu.py` (`permute_mont_mxu`, the JAX
package's MXU backend), a function beside `poseidon.permute_mont` with the
same contract: (16, t, B) Montgomery in and out, t = 3..7, canonical
output. A field element is 32 little-endian 8-bit limbs. Every product by
a constant is a banded matrix product: the MDS mix of all t outputs is one
(t*64, t*32) matrix against the (t*32, B) state, with the Montgomery-form
constants keeping the state in the Montgomery domain; the reduction is two
more products, by N' = -p^-1 mod 2^256 and by p. The S-box, a variable times
a variable, runs on the 16-bit limbs of `fr.mont_mul`. The dense circomlib
schedule: every round adds its constants, full rounds take x^5 of every
element and partial rounds of element 0 only, then the mix.

The products run in float64 on every device. JAX multiplies bf16 operands
with f32 accumulation and relies on every column staying below 2^24 (at
most t * 32 * 255^2). On the card a float32 product may run in TF32,
whose 10-bit mantissa is not exact, and CUDA has no int64 matrix product;
float64 holds every integer below 2^53 exactly on both devices.

Carries are resolved as in `fr`: vectorised passes bring every column to
at most 256, then one carry-lookahead step; the borrow of the conditional
subtraction of p is `d < 0` on the int64 limbs. Nothing here launches a
kernel of the port: the JAX module reaches no `pallas_call` either.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field import fr
from ..field.scalar import P, R as MONT_R
from .poseidon_constants import N_ROUNDS_F, N_ROUNDS_P, constants

NL8 = 32  # 8-bit limbs per element
N_PRIME = (-pow(P, -1, 1 << 256)) % (1 << 256)


def _limbs8(x: int, n: int = NL8) -> list[int]:
    return [(x >> (8 * i)) & 0xFF for i in range(n)]


def _banded(c: int, n_in: int, n_out: int) -> np.ndarray:
    """W[i, i + j] = limb8(c)[j]: x @ W gives the lazy columns of x * c,
    truncated at n_out."""
    w = np.zeros((n_in, n_out), np.float64)
    for i in range(n_in):
        for j, cj in enumerate(_limbs8(c)):
            if i + j < n_out:
                w[i, i + j] += cj
    return w


@lru_cache(maxsize=None)
def _np_mxu_constants(t: int):
    """(Wm, Wn, Wp, C8): the mix of all t outputs (t*32, t*64),
    block (j, i) the band of M[i][j] * R mod p; the reduction's bands of N'
    (32, 32) and p (32, 65); the round constants as 8-bit limb rows
    (rounds, t, 32), Montgomery form."""
    c, m = constants(t)
    wm = np.zeros((t * NL8, t * 2 * NL8), np.float64)
    for i in range(t):
        for j in range(t):
            wm[j * NL8:(j + 1) * NL8, i * 2 * NL8:(i + 1) * 2 * NL8] += \
                _banded((m[i][j] * MONT_R) % P, NL8, 2 * NL8)
    wn = _banded(N_PRIME, NL8, NL8)
    wp = _banded(P, NL8, 2 * NL8 + 1)
    c8 = np.array([[_limbs8((c[r * t + i] * MONT_R) % P) for i in range(t)]
                   for r in range(N_ROUNDS_F + N_ROUNDS_P[t - 2])], np.int64)
    return wm, wn, wp, c8


@lru_cache(maxsize=None)
def _tables(t: int, device: torch.device) -> dict:
    """The constants on `device`, limbs leading: each matrix transposed to
    multiply from the left, the round constants (rounds, 32, t, 1)."""
    wm, wn, wp, c8 = _np_mxu_constants(t)

    def f64(a):
        return torch.from_numpy(np.ascontiguousarray(a.T)).to(device)

    return dict(wm=f64(wm), wn=f64(wn), wp=f64(wp),
                c8=torch.from_numpy(c8.transpose(0, 2, 1)[..., None].copy()
                                    ).to(device),
                p8=torch.tensor(_limbs8(P), dtype=torch.int64,
                                device=device).reshape(NL8, 1, 1))


def _dot(w: torch.Tensor, a8: torch.Tensor) -> torch.Tensor:
    """w (n_out, n_in) float64 against a8 (n_in, *batch) limbs -> (n_out,
    *batch) int64 columns, exact (every column < 2^24)."""
    flat = a8.reshape(a8.shape[0], -1).to(torch.float64)
    return (w @ flat).to(torch.int64).reshape((w.shape[0],) + a8.shape[1:])


def _normalize(cols: torch.Tensor, n_out: int, passes: int = 3
               ) -> torch.Tensor:
    """Exact carry propagation in radix 2^8 of (n, *batch) columns, each
    below 2^24, to (n_out, *batch) limbs < 256 of the value mod
    2^(8 n_out). Three passes bring a column below 2^24 to at most 256, so
    the carry into each limb is 0 or 1 and `fr._lookahead` finds it."""
    n = cols.shape[0]
    if n < n_out:
        cols = torch.cat([cols, cols.new_zeros((n_out - n,) + cols.shape[1:])])
    c = cols[:n_out]
    for _ in range(passes):
        hi = c >> 8
        c = c & 255
        c[1:] += hi[:-1]
    carry = fr._lookahead(c > 255, c == 255)
    return (c + carry[:-1].to(torch.int64)) & 255


def _cond_sub_p(x8: torch.Tensor, p8: torch.Tensor, k: int = 1
                ) -> torch.Tensor:
    """x8 (32, *batch) limbs of a value < (k + 1) p: subtract p up to k
    times. The borrow out of a limb is `d < 0`, or `d == 0` with a borrow
    in."""
    for _ in range(k):
        d = x8 - p8
        borrow = fr._lookahead(d < 0, d == 0)
        diff = (d - borrow[:-1].to(torch.int64)) & 255
        x8 = torch.where(borrow[-1:], x8, diff)
    return x8


def _mont_reduce8(cols: torch.Tensor, t: int, tab: dict) -> torch.Tensor:
    """cols (65, *batch): the columns of a sum of at most t Montgomery
    products; returns (32, *batch) limbs of cols * R^-1 mod p, canonical."""
    tn = _normalize(cols, 2 * NL8 + 1)
    q = _normalize(_dot(tab["wn"], tn[:NL8]), NL8)  # lo * N' mod 2^256
    sn = _normalize(tn + _dot(tab["wp"], q), 2 * NL8 + 2)
    # (T + q p) / 2^256 < p (1 + t / 4): at most two subtractions
    return _cond_sub_p(sn[NL8:2 * NL8], tab["p8"], 2 if t > 3 else 1)


def _to16(x8: torch.Tensor) -> torch.Tensor:
    """(32, ...) 8-bit limbs -> (16, ...) 16-bit limbs (the fr layout)."""
    return x8[0::2] + (x8[1::2] << 8)


def _to8(x16: torch.Tensor) -> torch.Tensor:
    """(16, ...) 16-bit limbs -> (32, ...) 8-bit limbs."""
    return torch.stack([x16 & 255, x16 >> 8], dim=1).reshape(
        (NL8,) + x16.shape[1:])


def _pow5(x16: torch.Tensor) -> torch.Tensor:
    x2 = fr.mont_mul(x16, x16)
    x4 = fr.mont_mul(x2, x2)
    return fr.mont_mul(x4, x16)


def _mix(s8: torch.Tensor, t: int, tab: dict) -> torch.Tensor:
    """new[i] = sum_j M[i][j] s[j] for all i in one product; s8 (32, t,
    B)."""
    b = s8.shape[2]
    flat = s8.transpose(0, 1).reshape(t * NL8, b)
    cols = _dot(tab["wm"], flat).reshape(t, 2 * NL8, b).transpose(0, 1)
    cols = torch.cat([cols, cols.new_zeros((1, t, b))])
    return _mont_reduce8(cols, t, tab)


def permute_mont_mxu(state_m: torch.Tensor) -> torch.Tensor:
    """The Poseidon permutation, (16, t, B) Montgomery in and out, on
    8-bit limbs; equal to `poseidon.permute_mont` limb for limb."""
    t = state_m.shape[1]
    rf, rp = N_ROUNDS_F, N_ROUNDS_P[t - 2]
    tab = _tables(t, state_m.device)
    half = rf // 2
    x8 = _to8(state_m)
    for r in range(rf + rp):
        x8 = _cond_sub_p(_normalize(x8 + tab["c8"][r], NL8), tab["p8"])
        if r < half or r >= half + rp:
            x8 = _to8(_pow5(_to16(x8)))
        else:
            x8 = torch.cat([_to8(_pow5(_to16(x8[:, :1]))), x8[:, 1:]], dim=1)
        x8 = _mix(x8, t, tab)
    return _to16(x8)
