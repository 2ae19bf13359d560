"""The port's BN254 Fr limb arithmetic against the JAX package's `fr`, on
random values and on the edges 0, 1, p-1 and [2^253, p). Exact."""

import random

import jax
import numpy as np
import pytest
import torch

from circuits_tpu.field import fr as jfr
from circuits_tpu.field.scalar import P
from circuits_tpu_torch.field import fr

from torch_compare import assert_same, to_torch

rng = random.Random(2026)
EDGES = [0, 1, 2, P - 1, P - 2, 1 << 253, (1 << 253) + 1, P - (1 << 128),
         (1 << 16) - 1, (1 << 32) + 5]
A = EDGES + [rng.randrange(P) for _ in range(22)]
B = [P - 1, 0, P - 1, 1, P - 1, P - 1, 1 << 253, 5, 1, P - 3] + \
    [rng.randrange(P) for _ in range(22)]

A_NP, B_NP = jfr.pack_np(A), jfr.pack_np(B)
A_T, B_T = to_torch(A_NP), to_torch(B_NP)
COND = np.array([i % 3 == 0 for i in range(len(A))])

# name -> (port call, JAX call) on the (a, b) operands
BINARY = {
    "add": (fr.add, jfr.add),
    "sub": (fr.sub, jfr.sub),
    "mont_mul": (fr.mont_mul, jfr.mont_mul),
    "mul": (fr.mul, jfr.mul),
    "eq": (fr.eq, jfr.eq),
    "gt": (fr.gt, jfr.gt),
    "select": (lambda a, b: fr.select(torch.from_numpy(COND), a, b),
               lambda a, b: jfr.select(COND, a, b)),
    "sum_list": (lambda a, b: fr.sum_list([a, b, a, b, b]),
                 lambda a, b: jfr.sum_list([a, b, a, b, b])),
}
UNARY = {
    "neg": (fr.neg, jfr.neg),
    "to_mont": (fr.to_mont, jfr.to_mont),
    "from_mont": (fr.from_mont, jfr.from_mont),
    "is_zero": (fr.is_zero, jfr.is_zero),
    "bits_le_254": (lambda a: fr.bits_le(a, 254),
                    lambda a: jfr.bits_le(a, 254)),
    "bits_le_40": (lambda a: fr.bits_le(a, 40), lambda a: jfr.bits_le(a, 40)),
    "from_bits_le_256": (lambda a: fr.from_bits_le(fr.bits_le(a, 256)),
                         lambda a: jfr.from_bits_le(jfr.bits_le(a, 256))),
    "from_bits_le_100": (lambda a: fr.from_bits_le(fr.bits_le(a, 100)),
                         lambda a: jfr.from_bits_le(jfr.bits_le(a, 100))),
    "low_u32": (fr.low_u32, jfr.low_u32),
    "from_u32": (lambda a: fr.from_u32(fr.low_u32(a)),
                 lambda a: jfr.from_u32(jfr.low_u32(a))),
    "from_bool": (lambda a: fr.from_bool(fr.is_zero(a)),
                  lambda a: jfr.from_bool(jfr.is_zero(a))),
    "geq_const": (lambda a: fr.geq_const(a, 1 << 253),
                  lambda a: jfr.geq_const(a, 1 << 253)),
    "pow_const": (lambda a: fr.pow_const(a, 5), lambda a: jfr.pow_const(a, 5)),
    "inv": (fr.inv, jfr.inv),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_matches_jax(name):
    port, ref = BINARY[name]
    assert_same(port(A_T, B_T), jax.jit(ref)(A_NP, B_NP), name)


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_matches_jax(name):
    port, ref = UNARY[name]
    assert_same(port(A_T), jax.jit(ref)(A_NP), name)


def test_sqrt_matches_jax():
    # residues and non-residues alike: squares of A, then A itself
    sq = jfr.jmul(A_NP, A_NP)
    x_np = np.concatenate([np.asarray(sq), A_NP], axis=1)
    root, ok = fr.sqrt(to_torch(x_np))
    jroot, jok = jfr.jsqrt(x_np)
    assert_same(root, jroot, "root")
    assert_same(ok, jok, "ok")
    assert bool(ok[:len(A)].all())


@pytest.mark.parametrize("k", [0, 16, 32, 40, 72])
def test_shift_small_matches_jax(k):
    small = jfr.pack_np([v % (1 << 150) for v in A])
    assert_same(fr.shift_small(to_torch(small), k),
                jax.jit(lambda a: jfr.shift_small(a, k))(small))


def test_pack_unpack_roundtrip_and_const():
    assert np.array_equal(fr.pack_np(A), A_NP)
    assert [int(v) for v in fr.unpack_np(A_T)] == [v % P for v in A]
    assert fr.unpack_int(fr.const(P - 1)) == P - 1
    assert fr.unpack_int(fr.zeros((1,))) == 0
    assert fr.const(5, (3, 4)).shape == (16, 1, 1)


def _mont_rows_py(a: int, b: int) -> int:
    """`fr_mont_mul` of csrc/field.cuh, instruction by instruction: eight
    rows of `fr_mont_row`, each four carry chains of 32 x 32 -> 64
    multiply-adds on the aligned word pairs of two accumulators. A carry
    out of a chain's last word is asserted to be zero where the kernel
    drops it."""
    m32 = 0xFFFFFFFF
    pw = [(P >> (32 * i)) & m32 for i in range(8)]
    n0 = (-pow(P, -1, 1 << 32)) % (1 << 32)
    aw = [(a >> (32 * i)) & m32 for i in range(8)]
    bw = [(b >> (32 * i)) & m32 for i in range(8)]

    def mad_pairs(x, top, cs, m):
        """x[2k], x[2k+1] += cs[k] * m for k = 0..3 in one chain; the
        carry out goes to `top`."""
        carry = 0
        for k, c in enumerate(cs):
            prod = c * m
            for w, part in ((2 * k, prod & m32), (2 * k + 1, prod >> 32)):
                total = x[w] + part + carry
                x[w], carry = total & m32, total >> 32
        assert top + carry <= m32
        return top + carry

    def row(even, odd, bi):
        total = even[0] + odd[1]
        even[0], carry = total & m32, total >> 32
        old = list(odd)
        for k in range(4):  # odd[k] <- old odd[k + 2] + a's odd words * bi
            prod = aw[2 * k + 1] * bi
            for w, part in ((2 * k, prod & m32), (2 * k + 1, prod >> 32)):
                total = part + (old[w + 2] if w + 2 < 8 else 0) + carry
                odd[w], carry = total & m32, total >> 32
        assert carry == 0
        odd[7] = mad_pairs(even, odd[7], aw[0::2], bi)
        m = (even[0] * n0) & m32
        assert mad_pairs(odd, 0, pw[1::2], m) == 0
        odd[7] = mad_pairs(even, odd[7], pw[0::2], m)
        assert even[0] == 0

    even, odd = [0] * 8, [0] * 8
    for i in range(0, 8, 2):
        row(even, odd, bw[i])
        row(odd, even, bw[i + 1])
    value = sum((even[k] + (odd[k + 1] if k < 7 else 0)) << (32 * k)
                for k in range(8))
    assert value < 2 * P
    return value - P if value >= P else value


def test_kernel_mont_rows_mirror():
    """The word-level algorithm of the CUDA field product, mirrored in
    Python, equals a * b / 2^256 mod p on edge and random pairs, and never
    loses a carry."""
    rng = random.Random(77)
    r_inv = pow(1 << 256, -1, P)
    pairs = [(0, 0), (1, 1), (P - 1, P - 1), (P - 1, 1), (0, P - 1),
             ((1 << 253) - 1, P - 2)]
    pairs += [(rng.randrange(P), rng.randrange(P)) for _ in range(3000)]
    for a, b in pairs:
        assert _mont_rows_py(a, b) == a * b * r_inv % P, (a, b)
