"""The port's Poseidon (K1's plain versions on the CPU, in the sparse and
the dense schedule) against the JAX package's `poseidon` and
`permute_opt_body`, the host bigint `poseidon_py`, and the public circomlib
vectors. Exact: every comparison is limb for limb, tolerance 0."""

import random

import jax
import numpy as np
import pytest
import torch

from circuits_tpu.field import fr as jfr
from circuits_tpu.field.scalar import P
from circuits_tpu.ops import pallas_poseidon as jpp
from circuits_tpu.ops import poseidon as jpos
from circuits_tpu.ops.poseidon_constants import (N_ROUNDS_P,
                                                  optimized_constants,
                                                  poseidon_py)
from circuits_tpu_torch import convert
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


def _mont_state(t, lanes, seed):
    rng = random.Random(seed)
    vals = [[rng.randrange(P) for _ in range(lanes)] for _ in range(t)]
    for row in vals:  # edge values in the first lanes that exist
        row[:2] = [0, P - 1][:lanes]
    return jfr.pack_np(vals)  # (16, t, lanes), read as Montgomery form


@pytest.mark.parametrize("lanes", [1, 33])
@pytest.mark.parametrize("t", [3, 4, 5, 6, 7])
def test_sparse_plain_equals_dense_and_jax(t, lanes):
    """The sparse plain version == the dense one == the JAX package's
    permutation, at 1 and 33 lanes (not multiples of a thread group)."""
    state = _mont_state(t, lanes, 31 * t + lanes)
    x = to_torch(state)
    sparse = poseidon.permute_mont_plain(x, schedule="sparse")
    dense = poseidon.permute_mont_plain(x, schedule="dense")
    assert torch.equal(sparse, dense)
    assert torch.equal(poseidon.permute_mont_plain(x), sparse)
    assert_same(sparse, jax.jit(jpos.permute_mont)(state))
    with pytest.raises(ValueError):
        poseidon.permute_mont_plain(x, schedule="other")


@pytest.mark.parametrize("t", [3, 7])
def test_sparse_rounds_equal_jax_kernel_rounds(t):
    """The sparse plain version's rounds against `opt_full_round` and
    `opt_partial_round`, the functions `permute_opt_body` loops over inside
    the JAX Pallas kernel, run eagerly on the kernel's own constants as
    tests/test_kernel_bodies.py runs them (JAX layout (t, 16, S, 128), one
    row of 128 lanes; a whole body takes XLA:CPU minutes to compile)."""
    state = _mont_state(t, 128, 900 + t)
    x = to_torch(state)
    body_in = np.transpose(state, (1, 0, 2)).reshape(t, 16, 1, 128)
    cf, d, e, mc, ps, sr, sc = jpp._np_opt_constants(t)
    tab = poseidon._sparse_tables(t, x.device)

    def port_layout(a):
        return np.asarray(a).reshape(t, 16, 128).transpose(1, 0, 2)

    for r, jm, key in ((0, mc, "m"), (3, ps, "pre_sparse"), (7, mc, "m")):
        want = jpp.opt_full_round(body_in, cf[r], jm, t=t)
        got = poseidon._full_round(x, tab["full_c"][r], tab[key])
        assert_same(got, port_layout(want), f"full round {r}")
    for r in (0, len(e) - 1):
        want = jpp.opt_partial_round(body_in, e[r], sr[r], sc[r], t=t)
        got = poseidon._partial_round(x, tab["e"][r], tab["sparse"][r])
        assert_same(got, port_layout(want), f"partial round {r}")


def _helped_rounds_mirror(state, tab, t, rp, G):
    """`poseidon_partial_rounds_helped` of csrc/poseidon.cuh, thread by
    thread in bigints: G threads in lockstep (head 0, workers 1..t-1, helper
    t, passengers above), the same selects, shuffles, table offsets and
    prefetch. `tab` holds the kernel's own table parts as lists of
    Montgomery ints; `state` is t Montgomery ints."""
    r_inv = pow(1 << 256, -1, P)

    def mul(a, b):
        return a * b * r_inv % P

    ths = range(G)
    head = [i == 0 for i in ths]
    helper = [i == t for i in ths]
    iw = [min(i, t - 1) for i in ths]
    k1_row = [head[i] or helper[i] for i in ths]
    k1_tab = [tab["sparse_row"] if k1_row[i] else tab["sparse_col"][iw[i] - 1:]
              for i in ths]
    k1_t = [t if k1_row[i] else t - 1 for i in ths]
    k2_tab = [tab["row0_e"] if head[i] else tab["e"] if helper[i]
              else tab["sparse_row"][iw[i]:] for i in ths]
    k2_t = [1 if head[i] or helper[i] else t for i in ths]
    s = list(state) + [0] * (G - t)
    k1 = [k1_tab[i][0] for i in ths]
    k2 = [k2_tab[i][0] for i in ths]
    x0 = [0] * G
    s0 = [s[0]] * G
    for r in range(rp):
        rn = min(r + 1, rp - 1)
        n1 = [k1_tab[i][(rn if k1_row[i] else r) * k1_t[i]] for i in ths]
        n2 = [k2_tab[i][rn * k2_t[i]] for i in ths]
        a = [mul(s[i] if head[i] else k1[i],
                 s[i] if head[i] else s0[i] if helper[i] else x0[i])
             for i in ths]
        s = [s[i] if head[i] else (s[i] + a[i]) % P for i in ths]
        b = [mul(a[i] if head[i] else k2[i], a[i] if head[i] else s[i])
             for i in ths]
        total = sum(k2[i] if head[i] else b[i] if i < t else 0
                    for i in ths) % P
        c = [mul(a[t] if head[i] else s0[i], b[i] if head[i] else b[0])
             for i in ths]
        c = [(c[i] + (total if head[i] else k2[i])) % P for i in ths]
        s = [c[i] if head[i] else s[i] for i in ths]
        x0, s0 = [c[t]] * G, [c[0]] * G
        k1, k2 = n1, n2
    return [s[i] if head[i] else (s[i] + mul(k1[i], x0[i])) % P
            for i in ths][:t]


@pytest.mark.parametrize("t", [3, 5, 6, 7])
def test_kernel_helped_rounds_mirror(t):
    """K1's partial rounds with the helper thread (3 dependent products a
    round, the workers' column update a round late), mirrored in bigints on
    the kernel's own constant block, against the sparse schedule's partial
    rounds on the JAX package's `optimized_constants`."""
    rp, G = N_ROUNDS_P[t - 2], 4 if t <= 4 else 8
    sizes = dict(full_c=8 * t, d=t, e=rp, m=t * t, pre_sparse=t * t,
                 sparse_row=rp * t, sparse_col=rp * (t - 1), row0_e=rp)
    words = convert.poseidon_kernel_words().astype(object)
    start = sum(8 * u + u + 2 * N_ROUNDS_P[u - 2] + 2 * u * u
                + N_ROUNDS_P[u - 2] * (2 * u - 1) for u in range(3, t))
    tab = {}
    for key, n in sizes.items():
        tab[key] = [sum(int(w) << (32 * k) for k, w in enumerate(row))
                    for row in words[start:start + n]]
        start += n
    oc = optimized_constants(t)
    rng = random.Random(7 * t)
    for case in range(3):
        vals = [rng.randrange(P) for _ in range(t)]
        if case == 0:
            vals[:2] = [0, P - 1]
        want = list(vals)
        for r in range(rp):
            x = (pow(want[0], 5, P) + oc["e"][r]) % P
            new0 = (oc["sparse_row"][r][0] * x + sum(
                oc["sparse_row"][r][j] * want[j] for j in range(1, t))) % P
            want = [new0] + [(want[j] + oc["sparse_col"][r][j - 1] * x) % P
                             for j in range(1, t)]
        got = _helped_rounds_mirror([v * (1 << 256) % P for v in vals], tab,
                                    t, rp, G)
        assert [g * pow(1 << 256, -1, P) % P for g in got] == want


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
