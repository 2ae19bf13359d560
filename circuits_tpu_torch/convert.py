"""Parameter and state carry-over between the JAX package and the port.

* `packed_from_jax` turns the JAX `pack_rollup_inputs` dict (numpy or
  jax arrays, uint32) into the port's tensors and layout.
* The constant tables of the port -- Poseidon round constants and MDS
  matrices for t = 3..7, the SHA-256 K/H0 words and the EdDSA base-8 comb
  table -- are built here from the shared host code alone
  (`host.py`), never imported from a JAX module. The tests hold each of
  them equal to the JAX package's table.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .host import babyjub, poseidon_constants, scalar

N_LIMBS = scalar.N_LIMBS
POSEIDON_WIDTHS = (3, 4, 5, 6, 7)


def _mont_limbs(x: int) -> list[int]:
    return scalar.to_limbs((x * scalar.R) % scalar.P)


def _mont_words(x: int) -> list[int]:
    """Montgomery form (R = 2^256) as 8 little-endian 32-bit words -- the
    same value as the 16-limb form, split wider for the CUDA kernels."""
    v = (x * scalar.R) % scalar.P
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def n_rounds(t: int) -> tuple[int, int]:
    return (poseidon_constants.N_ROUNDS_F,
            poseidon_constants.N_ROUNDS_P[t - 2])


@lru_cache(maxsize=None)
def poseidon_tables(t: int):
    """Dense-schedule constants in Montgomery limbs: C (rounds, t, 16) and
    M (t, t, 16), uint32 (M[i][j] multiplies state[j] into new[i])."""
    C, M = poseidon_constants.constants(t)
    rf, rp = n_rounds(t)
    c = np.array([[_mont_limbs(C[r * t + i]) for i in range(t)]
                  for r in range(rf + rp)], dtype=np.uint32)
    m = np.array([[_mont_limbs(M[i][j]) for j in range(t)]
                  for i in range(t)], dtype=np.uint32)
    return c, m


@lru_cache(maxsize=None)
def poseidon_kernel_words() -> np.ndarray:
    """The CUDA kernels' constant block: for t = 3..7 in turn, the round
    constants (rounds * t elements) then the MDS matrix (t * t, row
    major), each element 8 Montgomery words. Layout must match
    `poseidon_offset` in csrc/poseidon.cuh. Shape (n_elements, 8)."""
    rows = []
    for t in POSEIDON_WIDTHS:
        C, M = poseidon_constants.constants(t)
        rf, rp = n_rounds(t)
        rows += [_mont_words(C[k]) for k in range((rf + rp) * t)]
        rows += [_mont_words(M[i][j]) for i in range(t) for j in range(t)]
    return np.array(rows, dtype=np.uint32)


def _first_primes(n: int) -> list[int]:
    out, k = [], 2
    while len(out) < n:
        if all(k % q for q in out if q * q <= k):
            out.append(k)
        k += 1
    return out


def _iroot(x: int, k: int) -> int:
    """floor(x ** (1/k)) for a non-negative integer x."""
    r = int(round(x ** (1.0 / k)))
    while r ** k > x:
        r -= 1
    while (r + 1) ** k <= x:
        r += 1
    return r


@lru_cache(maxsize=None)
def sha256_tables():
    """SHA-256 K (64,) and H0 (8,) words, from their definition: the first
    32 fraction bits of the cube roots of the first 64 primes and of the
    square roots of the first 8."""
    primes = _first_primes(64)
    k = [_iroot(p << 96, 3) & 0xFFFFFFFF for p in primes]
    h0 = [math.isqrt(p << 64) & 0xFFFFFFFF for p in primes[:8]]
    return np.array(k, dtype=np.uint32), np.array(h0, dtype=np.uint32)


@lru_cache(maxsize=None)
def comb_table() -> np.ndarray:
    """EdDSA fixed-base comb table (64, 16, 2, 16) uint32:
    TAB[j][d] = d * 16^j * BASE8, affine, Montgomery limbs; the d = 0 entry
    is the affine identity (0, 1). Built from the host curve code."""
    tab = np.zeros((64, 16, 2, N_LIMBS), dtype=np.uint32)
    base = babyjub.BASE8
    for j in range(64):
        pt = babyjub.IDENTITY
        for d in range(16):
            tab[j, d, 0] = _mont_limbs(pt[0])
            tab[j, d, 1] = _mont_limbs(pt[1])
            pt = babyjub.add_point(pt, base)
        for _ in range(4):
            base = babyjub.add_point(base, base)
    return tab


def limbs_to_words(limbs: np.ndarray) -> np.ndarray:
    """(..., 16) 16-bit limbs -> (..., 8) 32-bit words."""
    limbs = limbs.astype(np.uint32)
    return limbs[..., 0::2] | (limbs[..., 1::2] << np.uint32(16))


def packed_from_jax(packed: dict, device=None) -> dict:
    """JAX `pack_rollup_inputs` dict -> the port's dict: the same keys and
    shapes, every array an int64 tensor on `device`."""
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)).to(device)
            for k, v in packed.items()}
