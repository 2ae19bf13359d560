"""Parameter and state carry-over between the JAX package and the port.

* `packed_from_jax` turns the JAX `pack_rollup_inputs` dict (numpy or
  jax arrays, uint32) into the port's tensors and layout;
  `withdraw_args_to_jax` turns the port's packed Withdraw batch into the
  JAX `withdraw`'s positional arguments, and `debug_to_numpy` a torch debug
  dict into the numpy tree that the JAX one compares with.
* The constant tables of the port -- Poseidon round constants and MDS
  matrices for t = 3..7 in the dense and the sparse schedule, the SHA-256
  K/H0 words and the EdDSA base-8 comb table -- are built here from the
  port's own host code alone (`field/scalar.py`,
  `ops/poseidon_constants.py`, `builder/babyjub.py`).
  The tests hold each of them equal to the JAX package's table.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .builder import babyjub
from .field import scalar
from .ops import poseidon_constants

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


SPARSE_PARTS = ("full_c", "d", "e", "m", "pre_sparse", "sparse_row",
                "sparse_col")


@lru_cache(maxsize=None)
def _optimized(t: int) -> dict:
    return poseidon_constants.optimized_constants(t)


@lru_cache(maxsize=None)
def poseidon_sparse_tables(t: int) -> dict:
    """Sparse-schedule constants (`poseidon_constants.optimized_constants`)
    in Montgomery limbs, uint32, keyed by SPARSE_PARTS: full_c (8, t, 16),
    d (t, 16), e (rp, 16), m and pre_sparse (t, t, 16) (row i multiplies
    state[j] into new[i]), sparse_row (rp, t, 16), sparse_col
    (rp, t - 1, 16)."""
    oc = _optimized(t)

    def limbs(x):
        if isinstance(x, int):
            return _mont_limbs(x)
        return [limbs(v) for v in x]

    return {k: np.array(limbs(oc[k]), dtype=np.uint32) for k in SPARSE_PARTS}


def row0_e(t: int) -> np.ndarray:
    """sparse_row[r][0] * e[r] for every partial round, (rp, 16) Montgomery
    limbs, uint32: what a round adds to the new s[0] beside
    sparse_row[r][0] * s[0]^5, for the kernels that form that product without
    passing through x0 = s[0]^5 + e[r] (csrc/poseidon.cuh)."""
    oc = _optimized(t)
    return np.array([_mont_limbs(row[0] * e % scalar.P)
                     for row, e in zip(oc["sparse_row"], oc["e"])],
                    dtype=np.uint32)


@lru_cache(maxsize=None)
def poseidon_kernel_words() -> np.ndarray:
    """The CUDA kernels' constant block: for t = 3..7 in turn the parts of
    `poseidon_sparse_tables(t)` in SPARSE_PARTS order, each flattened row
    major, then `row0_e(t)`; each element 8 Montgomery words. Layout must
    match `sparse_block` in csrc/poseidon.cuh. Shape (3783, 8)."""
    blocks = []
    for t in POSEIDON_WIDTHS:
        tab = poseidon_sparse_tables(t)
        blocks += [tab[k].reshape(-1, N_LIMBS) for k in SPARSE_PARTS]
        blocks.append(row0_e(t))
    return limbs_to_words(np.concatenate(blocks))


ROUNDS_T = 3  # the full-round experiment's Poseidon width


@lru_cache(maxsize=None)
def rounds_tables():
    """The full-round experiment's constants as Montgomery limbs: CF
    (8, 3, 16), the optimized schedule's `full_c` (round r uses CF[r % 8]),
    and M (3, 3, 16), the MDS matrix (M[i][j] multiplies state[j] into
    new[i]). uint32."""
    oc = _optimized(ROUNDS_T)
    cf = np.array([[_mont_limbs(v) for v in row] for row in oc["full_c"]],
                  dtype=np.uint32)
    m = np.array([[_mont_limbs(v) for v in row] for row in oc["m"]],
                 dtype=np.uint32)
    return cf, m


@lru_cache(maxsize=None)
def rounds_kernel_words() -> np.ndarray:
    """K5/K6's constant block (33, 8) uint32: the 8 x 3 `full_c` elements
    (round-major) then the 3 x 3 MDS matrix (row major), each element 8
    Montgomery words. Layout must match ROUNDS_K in
    csrc/poseidon_rounds.cu."""
    cf, m = rounds_tables()
    return limbs_to_words(np.concatenate(
        [cf.reshape(-1, N_LIMBS), m.reshape(-1, N_LIMBS)]))


def _bytes_of(x: int, n: int = 32) -> list[int]:
    return [(x >> (8 * i)) & 0xFF for i in range(n)]


@lru_cache(maxsize=None)
def mix_matrices():
    """The banded byte matrices of K6's MDS mix and Montgomery reduction,
    uint8, every entry one byte of a constant:

    * Wm (3*64, 3*32): row e*64 + k, column j*32 + i. Times the byte
      columns X[j*32 + i] = byte i of state[j], it gives the 64 base-256
      columns of T_e = sum_j M[e][j] * state[j] (before carries).
    * Wn (32, 32): Wn[k, i] = byte k - i of N' = -p^-1 mod 2^256; times
      the low 32 bytes of T it gives the columns of q = lo * N' mod 2^256.
    * Wp (65, 32): Wp[i + k, i] = byte k of p; times q's bytes it gives
      the columns of q * p. Rows 63 and 64 are zero.

    K6 takes Wm alone, as `mix_fragments`; the plain version all three.
    """
    t = ROUNDS_T
    m = _optimized(t)["m"]
    wm = np.zeros((t * 64, t * 32), dtype=np.uint8)
    for e in range(t):
        for j in range(t):
            mb = _bytes_of((m[e][j] * scalar.R) % scalar.P)
            for i in range(32):
                wm[e * 64 + i:e * 64 + i + 32, j * 32 + i] = mb
    n_prime = (-pow(scalar.P, -1, 1 << 256)) % (1 << 256)
    wn = np.zeros((32, 32), dtype=np.uint8)
    wp = np.zeros((65, 32), dtype=np.uint8)
    nb, pb = _bytes_of(n_prime), _bytes_of(scalar.P)
    for i in range(32):
        wn[i:, i] = nb[:32 - i]
        wp[i:i + 32, i] = pb
    return wm, wn, wp


def mix_byte_column(nt: int, n: int) -> int:
    """The byte of T_e that column n (0..7) of n-tile nt (0..7) of K6's
    product holds: the permutation that gives the thread in place c of a
    quad (columns 2c, 2c + 1 of every n-tile) bytes 16c .. 16c + 15, each
    pair of n-tiles 2u, 2u + 1 one word."""
    return 16 * (n >> 1) + 4 * (nt >> 1) + 2 * (nt & 1) + (n & 1)


@lru_cache(maxsize=None)
def mix_fragments() -> np.ndarray:
    """K6's B operand, Wm^T with its columns permuted by
    `mix_byte_column`, in the register order of mma.m16n8k32's B fragment:
    (3, 8, 3, 32, 2) uint32 over (element e, n-tile nt, k-step j, thread,
    register). Thread 4g + c's register i holds column g at depths
    16i + 4c .. 16i + 4c + 3, lower depth in the lower byte; depth k of
    k-step j is byte k of state[j], column n of n-tile nt is byte
    `mix_byte_column(nt, n)` of T_e."""
    wm, _, _ = mix_matrices()
    t = ROUNDS_T
    out = np.zeros((t, 8, t, 32, 2), dtype=np.uint32)
    for e in range(t):
        for nt in range(8):
            for j in range(t):
                for lane in range(32):
                    g, c = lane >> 2, lane & 3
                    row = wm[e * 64 + mix_byte_column(nt, g), j * 32:]
                    for i in range(2):
                        k = 16 * i + 4 * c
                        out[e, nt, j, lane, i] = int.from_bytes(
                            bytes(row[k:k + 4].tolist()), "little")
    return out


def rounds_state_from_jax(x) -> torch.Tensor:
    """The experiment's JAX state (3, 16, S, 128) uint32 -> the port's
    (16, 3, B) int64, lane l = s * 128 + j at (s, j)."""
    x = np.asarray(x)
    t, n = x.shape[:2]
    flat = x.reshape(t, n, -1).transpose(1, 0, 2).astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(flat))


def rounds_state_to_jax(state: torch.Tensor, lanes: int = 128) -> np.ndarray:
    """The port's (16, 3, B) state -> JAX's (3, 16, B / lanes, lanes)
    uint32."""
    a = state.detach().cpu().numpy().astype(np.uint32).transpose(1, 0, 2)
    return np.ascontiguousarray(a.reshape(a.shape[:2] + (-1, lanes)))


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


def bjj_a1_constants() -> tuple[int, int]:
    """(sqrt(a), d / a) of BabyJubJub. a = 168700 is a square mod p, so
    (x, y) -> (sqrt(a) x, y) carries a x^2 + y^2 = 1 + d x^2 y^2 to
    x^2 + y^2 = 1 + (d / a) x^2 y^2; d / a is no square, so the addition law
    stays complete. The smaller of the two roots is taken."""
    root = scalar.fsqrt(babyjub.A)
    assert root is not None and root * root % scalar.P == babyjub.A
    return (min(root, scalar.P - root),
            babyjub.D * pow(babyjub.A, -1, scalar.P) % scalar.P)


COMB_ELEMS = 64 * 16 * 3  # elements of kernel K3's comb block


@lru_cache(maxsize=None)
def eddsa_kernel_words() -> np.ndarray:
    """Kernel K3's constant block (COMB_ELEMS + 2, 8) uint32, each element 8
    Montgomery words. The kernel works on the a = 1 form of the curve
    (`bjj_a1_constants`): entry (j, d) of the comb table is the three
    elements x' = sqrt(a) x, y and (d / a) x' y of (x, y) = d * 16^j * BASE8
    (`comb_table`), and the last two elements are sqrt(a) and d / a. Layout
    must match csrc/eddsa.cu."""
    root, d1 = bjj_a1_constants()
    rinv = pow(scalar.R, -1, scalar.P)
    tab = comb_table().astype(object)
    rows = []
    for entry in tab.reshape(-1, 2, N_LIMBS):
        x, y = (scalar.from_limbs([int(w) for w in c]) * rinv % scalar.P
                for c in entry)
        x1 = root * x % scalar.P
        rows += [_mont_words(x1), _mont_words(y),
                 _mont_words(d1 * x1 * y % scalar.P)]
    rows += [_mont_words(root), _mont_words(d1)]
    return np.array(rows, dtype=np.uint32)


def limbs_to_words(limbs: np.ndarray) -> np.ndarray:
    """(..., 16) 16-bit limbs -> (..., 8) 32-bit words."""
    limbs = limbs.astype(np.uint32)
    return limbs[..., 0::2] | (limbs[..., 1::2] << np.uint32(16))


def packed_from_jax(packed: dict, device=None) -> dict:
    """JAX `pack_rollup_inputs` dict -> the port's dict: the same keys and
    shapes, every array an int64 tensor on `device`."""
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)).to(device)
            for k, v in packed.items()}


WITHDRAW_ARGS = ("root_exit", "eth_addr", "token_id", "balance", "idx",
                 "sign", "ay", "siblings_state")


def withdraw_args_to_jax(packed: dict) -> tuple:
    """`pack_withdraw_inputs`' dict -> the positional arguments of the JAX
    package's `withdraw(n_levels, ...)`, numpy uint32 in its layout (the
    same shapes), so one packed batch feeds both packages."""
    return tuple(packed[k].detach().cpu().numpy().astype(np.uint32)
                 for k in WITHDRAW_ARGS)


def debug_to_numpy(tree):
    """A debug tree of the port (nested dicts / tuples of tensors) -> the
    same tree of numpy arrays: int64 limbs, bits and flags, bool
    predicates kept bool; compare with the JAX tree value for value."""
    if isinstance(tree, dict):
        return {k: debug_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(debug_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
