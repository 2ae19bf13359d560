"""Poseidon round constants / MDS matrices for BN254 Fr, circomlib-compatible.

circomlib 0.5.x (the reference's pinned gadget library,
the reference's package.json:27) ships constants generated by the Poseidon
paper's reference script ``generate_parameters_grain.sage`` with parameters
(field=1 prime field, sbox=0 i.e. x^alpha, n=254, t, R_F=8, R_P from the
table below). We regenerate them here from the Grain-LFSR specification —
nothing is copied; correctness is pinned by the public circomlib test
vectors in tests/test_poseidon.py.
"""

from __future__ import annotations

from functools import lru_cache

from .scalar import P

N_ROUNDS_F = 8
# Partial rounds per state width t = 2..17 (circomlib's table).
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]


class _Grain:
    """Grain LFSR in "shrinking" mode, per the Poseidon reference scripts."""

    def __init__(self, field: int, sbox: int, n: int, t: int,
                 r_f: int, r_p: int):
        bits = []
        for value, width in ((field, 2), (sbox, 4), (n, 12), (t, 12),
                             (r_f, 10), (r_p, 10)):
            bits += [int(b) for b in bin(value)[2:].zfill(width)]
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._update()

    def _update(self) -> int:
        s = self.state
        new_bit = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new_bit)
        return new_bit

    def random_bits(self, num_bits: int) -> int:
        bits = []
        while len(bits) < num_bits:
            bit1 = self._update()
            bit2 = self._update()
            if bit1:
                bits.append(bit2)
        value = 0
        for b in bits:  # MSB first
            value = (value << 1) | b
        return value

    def field_element(self) -> int:
        while True:
            v = self.random_bits(254)
            if v < P:
                return v


@lru_cache(maxsize=None)
def constants(t: int):
    """Returns (C, M) for state width t: C is a flat list of
    (R_F + R_P) * t round constants; M is the t x t MDS matrix
    (Cauchy: M[i][j] = 1/(x_i + y_j)), both as Python ints."""
    r_p = N_ROUNDS_P[t - 2]
    g = _Grain(field=1, sbox=0, n=254, t=t, r_f=N_ROUNDS_F, r_p=r_p)
    n_consts = (N_ROUNDS_F + r_p) * t
    c = [g.field_element() for _ in range(n_consts)]
    xs = [g.random_bits(254) % P for _ in range(t)]
    ys = [g.random_bits(254) % P for _ in range(t)]
    m = [[pow((xs[i] + ys[j]) % P, -1, P) for j in range(t)]
         for i in range(t)]
    return c, m


def poseidon_py(inputs: list[int]) -> int:
    """Host-side Poseidon hash, circomlib semantics. Dispatches to the
    native C++ library (native/fr_poseidon.cpp) where it can be built — the
    batch builder's sequential SMT chain is Poseidon-bound — and to the
    pure-bigint implementation below otherwise (which doubles as the
    oracle in the tests)."""
    from . import native

    lib = native.library()
    if lib is not None:
        return native.poseidon_native(lib, [x % P for x in inputs])
    return poseidon_py_pure(inputs)


def poseidon_py_pure(inputs: list[int]) -> int:
    """Pure-bigint Poseidon, circomlib semantics:
    state = [0, *inputs]; every round: ark -> sbox -> mix; output state[0].

    The mix orientation (new[i] = sum_j M[i][j] state[j] with our Cauchy
    construction M[i][j] = 1/(x_i+y_j), xs-then-ys from the continuing
    Grain stream) was pinned by an exhaustive structure search against the
    public circomlib test vectors — it is the unique match."""
    n = len(inputs)
    t = n + 1
    assert 1 <= n <= 16
    c, m = constants(t)
    r_f = N_ROUNDS_F
    r_p = N_ROUNDS_P[t - 2]
    state = [0] + [x % P for x in inputs]
    for r in range(r_f + r_p):
        state = [(a + c[r * t + i]) % P for i, a in enumerate(state)]
        if r < r_f // 2 or r >= r_f // 2 + r_p:
            state = [pow(a, 5, P) for a in state]
        else:
            state[0] = pow(state[0], 5, P)
        state = [
            sum(m[i][j] * state[j] for j in range(t)) % P
            for i in range(t)
        ]
    return state[0]


# ---------------------------------------------------------------------------
# Optimized partial-round schedule (sparse-matrix factorization)
# ---------------------------------------------------------------------------


def _mat_mul(A, B):
    t = len(A)
    return [[sum(A[i][k] * B[k][j] for k in range(t)) % P
             for j in range(t)] for i in range(t)]


def _mat_vec(A, v):
    t = len(A)
    return [sum(A[i][k] * v[k] for k in range(t)) % P for i in range(t)]


def _mat_inv(A):
    t = len(A)
    M = [[A[i][j] % P for j in range(t)] + [1 if i == j else 0
                                            for j in range(t)]
         for i in range(t)]
    for col in range(t):
        piv = next(r for r in range(col, t) if M[r][col] % P)
        M[col], M[piv] = M[piv], M[col]
        inv = pow(M[col][col], P - 2, P)
        M[col] = [(x * inv) % P for x in M[col]]
        for r in range(t):
            if r != col and M[r][col]:
                f = M[r][col]
                M[r] = [(M[r][j] - f * M[col][j]) % P
                        for j in range(2 * t)]
    return [row[t:] for row in M]


def optimized_constants(t: int):
    """Sparse partial-round schedule, bit-exact to the naive circomlib
    order (validated by scripts/poseidon_opt_proto.py + unit tests).

    Each partial round's dense t*t MDS mix factors as N = S . M'' with
    M'' = diag(1, B): M'' commutes left past the lane-0 S-box into the
    previous round's mix, leaving a sparse S (dense row 0, dense column
    0, identity elsewhere — 2t-1 muls). Non-lane-0 ARK constants fold
    backward through M^-1; lane-0 leftovers become post-S-box adds.

    Returns dict:
      full_c  (rf, t): pre-sbox ARKs of the rf full rounds, in execution
               order (first half then second half)
      d       (t,): pre-sbox ARK vector of the first partial round
               (all folded tails, transformed by M''_0)
      e       (rp,): post-sbox lane-0 constants (e[rp-1] = 0)
      m       (t, t): the MDS matrix (full rounds except the pre-sparse)
      pre_sparse (t, t): mix of the LAST first-half full round
      sparse_row (rp, t), sparse_col (rp, t-1): per-partial-round sparse
               factors (row 0 / column-0 tail)
    Evaluation order per partial round r:
      r==0: state += d ; x0 = x0^5 ; x0 += e[r] ; sparse apply.
    """
    C, Mfull = constants(t)
    rf, rp = N_ROUNDS_F, N_ROUNDS_P[t - 2]
    half = rf // 2
    M = [list(r) for r in Mfull]
    Minv = _mat_inv(M)
    cst = [[C[r * t + i] % P for i in range(t)] for r in range(rf + rp)]

    # equivalent constants: move non-lane0 partial ARKs backward
    for i in range(half + rp - 1, half, -1):
        inv = _mat_vec(Minv, cst[i])
        cst[i] = [inv[0]] + [0] * (t - 1)
        for j in range(1, t):
            cst[i - 1][j] = (cst[i - 1][j] + inv[j]) % P

    # matrices: factor N = S . M'' per partial round (last to first)
    sparse = []
    N = [list(r) for r in M]
    last_B = None
    for _ in range(rp):
        B = [[N[i][j] for j in range(1, t)] for i in range(1, t)]
        Binv = _mat_inv(B)
        v_s = [sum(N[0][k + 1] * Binv[k][j] for k in range(t - 1)) % P
               for j in range(t - 1)]
        sparse.append(([N[0][0]] + v_s, [N[i][0] for i in range(1, t)]))
        mpp = [[1 if (i == j == 0) else
                (0 if (i == 0 or j == 0) else B[i - 1][j - 1])
                for j in range(t)] for i in range(t)]
        N = _mat_mul(mpp, M)
        last_B = B
    sparse.reverse()
    pre_sparse = N
    # the first partial round's folded ARK crosses M''_0 = diag(1, B_0)
    D = cst[half]
    D = [D[0]] + _mat_vec(last_B, D[1:])

    full_c = [cst[r] for r in range(half)] + \
             [cst[r] for r in range(half + rp, rf + rp)]
    e = [cst[half + 1 + r][0] for r in range(rp - 1)] + [0]
    return dict(full_c=full_c, d=D, e=e, m=M, pre_sparse=pre_sparse,
                sparse_row=[s[0] for s in sparse],
                sparse_col=[s[1] for s in sparse])
