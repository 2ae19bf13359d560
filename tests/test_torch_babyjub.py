"""The port's public BabyJubJub point operations against the JAX package
and the host curve code, plus the two small names that came with them
(`make_rollup_main`, `poseidon_native_batch`): `scalar_mul_base8` equals the
host's `mul_point(k, BASE8)` affinely; `scalar_mul_var(B8)` is
`points_equal` to it; the projective limbs of both, and of `identity`,
`from_affine_mont`, `pselect` and `points_equal`, equal the JAX functions'
exactly on seeded scalars that include 0, 1, SUB_ORDER - 1 and values with
bit 252 set."""

import numpy as np
import pytest

from circuits_tpu.field import fr as jfr
from circuits_tpu.models.rollup_main import make_rollup_main as jmake
from circuits_tpu.ops import babyjubjub as jbjj
from circuits_tpu.utils import native as jnative
from circuits_tpu.engine.witness import pack_rollup_inputs as jpack
from circuits_tpu_torch.builder import babyjub
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.field.scalar import P
from circuits_tpu_torch.models.rollup_main import make_rollup_main
from circuits_tpu_torch.ops import babyjubjub as bjj
from circuits_tpu_torch.utils import native
from circuits_tpu_torch.engine.witness import pack_rollup_inputs

from torch_compare import (SUITE_CONFIG, assert_same, oracle_outputs,
                           suite_batches, to_torch)

S_BITS = 253


def _scalars():
    rng = np.random.default_rng(2026)
    ks = [0, 1, babyjub.SUB_ORDER - 1, 1 << 252, (1 << S_BITS) - 1,
          (1 << 252) | int(rng.integers(1 << 62))]
    ks += [int.from_bytes(rng.bytes(32), "little") % babyjub.SUB_ORDER
           for _ in range(4)]
    return ks


KS = _scalars()


@pytest.fixture(scope="module")
def bits():
    """(port bits, JAX bits) of KS, 253 bits each."""
    b = fr.bits_le(fr.pack(KS), S_BITS)
    return b, jfr.bits_le(jfr.pack(KS), S_BITS)


@pytest.fixture(scope="module")
def base8(bits):
    return bjj.scalar_mul_base8(bits[0]), jbjj.jscalar_mul_base8(bits[1])


def _b8(n):
    """BASE8 as a projective Montgomery point over n lanes, both packages."""
    xs, ys = [babyjub.BASE8[0]] * n, [babyjub.BASE8[1]] * n
    return (bjj.from_affine_mont(fr.to_mont(fr.pack(xs)),
                                 fr.to_mont(fr.pack(ys))),
            jbjj.from_affine_mont(jfr.to_mont(jfr.pack(xs)),
                                  jfr.to_mont(jfr.pack(ys))))


@pytest.fixture(scope="module")
def var_b8(bits):
    pt, jpt = _b8(len(KS))
    return bjj.scalar_mul_var(bits[0], pt), jbjj.jscalar_mul_var(bits[1], jpt)


def _affine(pt):
    x, y, z = (fr.from_mont(c) for c in pt)
    zinv = fr.inv(z)
    return (fr.unpack_np(fr.mul(x, zinv)), fr.unpack_np(fr.mul(y, zinv)))


def test_bits_match_jax(bits):
    assert_same(bits[0], bits[1], "bits")


def test_scalar_mul_base8_equals_host(base8):
    gx, gy = _affine(base8[0])
    for k, x, y in zip(KS, gx, gy):
        assert (int(x), int(y)) == babyjub.mul_point(k, babyjub.BASE8), k


def test_scalar_mul_base8_limbs_equal_jax(base8):
    assert_same(base8[0], base8[1], "scalar_mul_base8")


def test_scalar_mul_var_limbs_equal_jax(var_b8):
    assert_same(var_b8[0], var_b8[1], "scalar_mul_var")


def test_scalar_mul_var_b8_equals_base8(base8, var_b8):
    eq = bjj.points_equal(var_b8[0], base8[0])
    assert eq.tolist() == [True] * len(KS)
    assert_same(eq, jbjj.points_equal(var_b8[1], base8[1]), "points_equal")


def test_scalar_mul_var_other_point_equals_host(bits):
    """A base point that is not BASE8: 5 * BASE8, its projective form
    scaled by a random Z so that Z != 1 enters every lane."""
    q = babyjub.mul_point(5, babyjub.BASE8)
    zs = [int(v) % P for v in np.random.default_rng(9).integers(
        2, 1 << 62, len(KS))]
    coords = [[q[0] * z % P for z in zs], [q[1] * z % P for z in zs], zs]
    pt = tuple(fr.to_mont(fr.pack(c)) for c in coords)
    jpt = tuple(jfr.to_mont(jfr.pack(c)) for c in coords)
    got = bjj.scalar_mul_var(bits[0], pt)
    assert_same(got, jbjj.jscalar_mul_var(bits[1], jpt), "var(5 B8)")
    gx, gy = _affine(got)
    for k, x, y in zip(KS, gx, gy):
        assert (int(x), int(y)) == babyjub.mul_point(k, q), k


@pytest.mark.parametrize("bshape", [(3,), (2, 3)])
def test_identity_equals_jax(bshape):
    assert_same(bjj.identity(bshape), jbjj.identity(bshape), "identity")


def test_from_affine_mont_and_pselect_equal_jax(base8):
    pt, jpt = _b8(len(KS))
    assert_same(pt, jpt, "from_affine_mont")
    cond = np.array([k % 2 for k in range(len(KS))], dtype=np.int64)
    assert_same(bjj.pselect(to_torch(cond), pt, base8[0]),
                jbjj.pselect(cond.astype(np.uint32), jpt, base8[1]),
                "pselect")


def test_points_equal_equals_jax(base8):
    """Equal points in other projective forms, and unequal points."""
    pt, jpt = base8
    z = fr.to_mont(fr.pack([7 + k for k in range(len(KS))]))
    jz = jfr.to_mont(jfr.pack([7 + k for k in range(len(KS))]))
    scaled = tuple(fr.mont_mul(c, z) for c in pt)
    jscaled = tuple(jfr.mont_mul(c, jz) for c in jpt)
    shifted = tuple(c.roll(1, dims=-1) for c in pt)
    jshifted = tuple(np.roll(np.asarray(c), 1, axis=-1) for c in jpt)
    same = bjj.points_equal(pt, scaled)
    assert same.all()
    assert_same(same, jbjj.points_equal(jpt, jscaled), "equal")
    diff = bjj.points_equal(pt, shifted)
    assert_same(diff, jbjj.points_equal(jpt, jshifted), "shifted")
    assert diff.tolist() == [KS[i] == KS[i - 1] for i in range(len(KS))]


def test_make_rollup_main_equals_jax():
    bb = suite_batches()["l2"]
    inp = bb.get_input()
    out, ok = make_rollup_main(*SUITE_CONFIG)(
        pack_rollup_inputs(inp, *SUITE_CONFIG, device="cpu"))
    jout, jok = jmake(*SUITE_CONFIG)(jpack(inp, *SUITE_CONFIG))
    assert bool(ok) and bool(jok)
    assert_same(out, jout, "rollup_main")
    assert fr.unpack_int(out["hash_global_inputs"]) == \
        oracle_outputs(bb)["hash_global_inputs"]


def test_poseidon_native_batch_equals_jax():
    lib = native.library()
    if lib is None or jnative._lib is None:
        pytest.skip("no C++ compiler to build the native Poseidon")
    rng = np.random.default_rng(5)
    for n in (1, 2, 5):
        rows = [[int.from_bytes(rng.bytes(32), "little") % P
                 for _ in range(n)] for _ in range(3)]
        rows.append([0] * n)
        rows.append([P - 1] * n)
        got = native.poseidon_native_batch(lib, n, rows)
        assert got == jnative.poseidon_native_batch(n, rows), n
        assert got == [native.poseidon_native(lib, r) for r in rows], n
