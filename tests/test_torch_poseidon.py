"""The port's Poseidon (K1's plain version on the CPU) against the JAX
package's `poseidon`, the host bigint `poseidon_py`, and the public
circomlib vectors. Exact."""

import random

import jax
import numpy as np
import pytest
import torch

from circuits_tpu.field import fr as jfr
from circuits_tpu.field.scalar import P
from circuits_tpu.ops import poseidon as jpos
from circuits_tpu.ops.poseidon_constants import poseidon_py
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.ops import poseidon

from torch_compare import assert_same, to_torch

# the public circomlib / go-iden3-crypto vectors of tests/test_poseidon.py
VECTORS = {
    (1,): 18586133768512220936620570745912940619677854269274689475585506675881198879027,
    (1, 2): 7853200120776062878684798364095072458815029376092732009249414926327459813530,
    (1, 2, 3, 4): 18821383157269793795438455681495246036402687001665670618754263018637548127333,
    (1, 2, 0, 0, 0): 1018317224307729531995786483840663576608797660851238720571059489595066344487,
    (1, 2, 3, 4, 5, 6): 20400040500897583745843009878988256314335038853985262692600694741116813247201,
}


@pytest.mark.parametrize("inp", sorted(VECTORS))
def test_circomlib_vectors(inp):
    got = poseidon.poseidon([fr.pack([v]) for v in inp])
    assert fr.unpack_int(got) == VECTORS[inp]


@pytest.mark.parametrize("t", [3, 4, 5, 6, 7])
def test_hash_matches_jax_and_host(t):
    rng = random.Random(100 + t)
    cols = [[rng.randrange(P) for _ in range(5)] + [0, P - 1]
            for _ in range(t - 1)]
    arrs = [jfr.pack_np(c) for c in cols]
    got = poseidon.poseidon([to_torch(a) for a in arrs])
    assert_same(got, jpos.jposeidon(arrs))
    assert [int(v) for v in fr.unpack_np(got)] == [
        poseidon_py([c[b] for c in cols]) for b in range(len(cols[0]))]


@pytest.mark.parametrize("t", [3, 7])
def test_permute_plain_matches_jax_permute(t):
    rng = np.random.default_rng(t)
    vals = [[int(x) * (2**190 + 7) % P for x in rng.integers(0, 2**62, 6)]
            for _ in range(t)]
    state = jfr.pack_np(vals)  # (16, t, 6) Montgomery form
    got = poseidon.permute_mont_plain(to_torch(state))
    want = jax.jit(jpos.permute_mont)(state)
    assert_same(got, want)
    # the wrapper takes the plain version for a CPU tensor
    assert_same(poseidon.permute_mont(to_torch(state)), want)


def test_batched_shapes_broadcast():
    a = fr.pack([[1, 2], [3, 4]])      # (16, 2, 2)
    b = fr.const(9, (2, 2))            # broadcast constant
    got = poseidon.poseidon([a, b])
    assert got.shape == (16, 2, 2)
    assert fr.unpack_np(got)[1, 0] == poseidon_py([3, 9])


def test_wrapper_refuses_other_devices():
    # a tensor neither on the CPU nor on a CUDA device is refused, never
    # routed to the plain version
    with pytest.raises(ValueError):
        poseidon.permute_mont(torch.zeros((16, 3, 4), dtype=torch.int64,
                                          device="meta"))
