"""The port's 8-bit-limb Poseidon permutation (`permute_mont_mxu`) against
the JAX package's `jpermute_mont_mxu`, the port's `permute_mont_plain` (the
plain version of kernel K1) and the host `poseidon_py`, for t = 3..7: limb
for limb and hash for hash, on seeded lanes and on lanes whose inputs are
all 0 or all p - 1. The output is canonical, so the equality is exact, with
no reduction mod p. Also the cases of tests/test_poseidon_mxu.py."""

import random

import numpy as np
import pytest
import torch

from circuits_tpu.field import fr as jfr
from circuits_tpu.ops.poseidon_mxu import jpermute_mont_mxu
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.field.scalar import P
from circuits_tpu_torch.ops import poseidon_mxu
from circuits_tpu_torch.ops.poseidon import permute_mont_plain
from circuits_tpu_torch.ops.poseidon_constants import poseidon_py

from torch_compare import to_np

WIDTHS = [3, 4, 5, 6, 7]


def _rows(t, n_random=3, seed=0):
    """Hash inputs, one row a lane: seeded values, then all 0, all p - 1."""
    rng = np.random.default_rng(100 + t + seed)
    rows = [[int.from_bytes(rng.bytes(32), "little") % P
             for _ in range(t - 1)] for _ in range(n_random)]
    return rows + [[0] * (t - 1), [P - 1] * (t - 1)]


def _state(rows):
    """(16, t, B) Montgomery state of the hash of each row (capacity 0)."""
    cols = [[0] * len(rows)] + [list(c) for c in zip(*rows)]
    return fr.to_mont(fr.pack(cols))


@pytest.mark.parametrize("t", WIDTHS)
def test_mxu_equals_jax_plain_and_host(t):
    rows = _rows(t)
    st = _state(rows)
    got = poseidon_mxu.permute_mont_mxu(st)
    want = np.asarray(jpermute_mont_mxu(
        jfr.to_mont(jfr.pack(fr.unpack_np(fr.from_mont(st)).tolist()))))
    assert np.array_equal(to_np(got), want.astype(np.int64))
    assert bool((got == permute_mont_plain(st)).all())
    assert bool((got < 1 << 16).all() and (got >= 0).all())
    h = fr.unpack_np(fr.from_mont(got[:, 0]))
    assert [int(v) for v in h] == [poseidon_py(r) for r in rows]


@pytest.mark.parametrize("t", [3, 5])
def test_mxu_full_state_equals_dense_schedule(t):
    """A state with nonzero capacity, every element random: the whole
    output state against the dense circomlib schedule."""
    rng = random.Random(31 + t)
    vals = [[rng.randrange(P) for _ in range(4)] for _ in range(t)]
    vals[0][1] = P - 1
    st = fr.to_mont(fr.pack(vals))
    got = poseidon_mxu.permute_mont_mxu(st)
    assert bool((got == permute_mont_plain(st, schedule="dense")).all())


def test_normalize_and_cond_sub_p_edges():
    """The carry ripple through 255-limbs and the borrow of p itself:
    p - 1, p, p + 255 and 2p - 1, one subtraction each; and columns at the
    bound the passes are made for, every column 2^24 - 1."""
    vals = [P - 1, P, P + 255, 2 * P - 1]
    limbs = torch.tensor([poseidon_mxu._limbs8(v) for v in vals]).T
    x8 = poseidon_mxu._normalize(limbs[:, None, :], 32)
    p8 = poseidon_mxu._tables(3, x8.device)["p8"]
    red = poseidon_mxu._cond_sub_p(x8, p8)
    got = [sum(int(red[i, 0, j]) << (8 * i) for i in range(32))
           for j in range(len(vals))]
    assert got == [P - 1, 0, 255, P - 1]
    cols = torch.full((65, 1, 1), (1 << 24) - 1)
    n = poseidon_mxu._normalize(cols, 66)
    want = sum(((1 << 24) - 1) << (8 * i) for i in range(65)) % (1 << 528)
    assert sum(int(n[i, 0, 0]) << (8 * i) for i in range(66)) == want
