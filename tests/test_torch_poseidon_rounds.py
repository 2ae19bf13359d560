"""The full-round experiment's plain versions (K5's and K6's, on the CPU)
against the JAX bodies of scripts/exp_mxu_inkernel.py and the bigint
mirror, and K6's step order mirrored in Python integers against both.
Exact everywhere.

JAX's MXU body returns some lanes as x + p (its final subtract of p is a
no-op, because `_P16 = to_limbs(P)` reduces p to zero), so the port is held
against it exactly where JAX's value is below p and mod p everywhere. The
JAX bodies run eagerly: XLA:CPU compiles the raw-limb round graphs slowly.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuits_tpu.field.scalar import P, R
from circuits_tpu.ops import pallas_poseidon as pp
from circuits_tpu_torch import convert
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.ops import poseidon_rounds as pr
from circuits_tpu_torch.scripts import exp_mxu_inkernel, rounds_cases

from torch_compare import assert_same

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / \
    "exp_mxu_inkernel.py"
N_PRIME = (-pow(P, -1, 1 << 256)) % (1 << 256)


@pytest.fixture(scope="module")
def jexp():
    """The JAX experiment script as a module. It reads sys.argv[1:3] as
    integers when imported, so argv is cut to the script's name first."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [str(SCRIPT)])
        spec = importlib.util.spec_from_file_location("exp_mxu_inkernel_jax",
                                                      SCRIPT)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _ints(state: torch.Tensor) -> list[list[int]]:
    """(16, 3, B) limbs -> 3 lists of ints, without any reduction."""
    u = fr.unpack_np(state)
    return [[int(v) for v in u[e]] for e in range(3)]


def _mirror(vals, rounds):
    lanes = len(vals[0])
    outs = [pr.full_rounds_py([vals[e][b] for e in range(3)], rounds)
            for b in range(lanes)]
    return [[outs[b][e] for b in range(lanes)] for e in range(3)]


# ---------------------------------------------------------------------------
# tables and converters
# ---------------------------------------------------------------------------


def test_round_tables_equal_jax_constants():
    CF, _, _, Mc, _, _, _ = pp._np_opt_constants(3)
    cf, m = convert.rounds_tables()
    assert np.array_equal(cf, CF[..., 0, 0])
    assert np.array_equal(np.broadcast_to(m[..., None], Mc[..., 0, :].shape),
                          Mc[..., 0, :])
    words = convert.rounds_kernel_words()
    assert words.shape == (33, 8)
    assert np.array_equal(words[:24], convert.limbs_to_words(
        CF[..., 0, 0].reshape(24, 16)))
    assert np.array_equal(words[24:], convert.limbs_to_words(
        Mc[..., 0, 0].reshape(9, 16)))


def test_mix_matrices_equal_jax_in_the_ports_byte_order(jexp):
    wm, wn, wp = convert.mix_matrices()
    jwm, jwn, jwp, _, _, _ = jexp._mxu_consts()
    # JAX's input column j*32 + h*16 + i is byte 2i + h of element j
    perm = [j * 32 + (pos % 2) * 16 + pos // 2 for j in range(3)
            for pos in range(32)]
    assert np.array_equal(wm.astype(np.float32), jwm[:, perm])
    assert wm.max() <= 255 and wn.dtype == wp.dtype == np.uint8
    assert np.array_equal(wn.astype(np.float32), jwn[:32, :32])
    assert np.array_equal(wp.astype(np.float32), jwp[:65, :32])
    assert not wp[63:].any()  # the kernel multiplies by Wp's first 64 rows


def test_state_converters_round_trip():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 16, size=(3, 16, 2, 128), dtype=np.uint32)
    t = convert.rounds_state_from_jax(x)
    assert t.shape == (16, 3, 256) and t.dtype == torch.int64
    assert int(t[5, 2, 128 + 7]) == int(x[2, 5, 1, 7])
    back = convert.rounds_state_to_jax(t)
    assert back.dtype == np.uint32 and np.array_equal(back, x)


# ---------------------------------------------------------------------------
# the plain versions against the JAX bodies
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lanes128():
    """128 lanes of the JAX script's own random state (default_rng(5))."""
    state, vals = exp_mxu_inkernel.random_state(128)
    return state, vals


def test_vpu_plain_matches_opt_full_round(lanes128):
    state, _ = lanes128
    CF, _, _, Mc, _, _, _ = [jnp.asarray(c) for c in pp._np_opt_constants(3)]
    s = jnp.asarray(convert.rounds_state_to_jax(state))
    for r in range(3):  # eager: see the module docstring
        s = pp.opt_full_round(s, CF[r % 8], Mc, t=3)
    got = pr.full_rounds_vpu_plain(state, 3)
    assert_same(got, convert.rounds_state_from_jax(np.asarray(s)))


@pytest.fixture(scope="module")
def mxu_two_rounds(jexp, lanes128):
    """JAX's `_mxu_round_body` looped twice (S = 1, 128 lanes) and the
    port's plain MXU rounds on the same state."""
    state, _ = lanes128
    wm, wn, wp, pick, _, _ = [jnp.asarray(w) for w in jexp._mxu_consts()]
    CF = jnp.asarray(pp._np_opt_constants(3)[0])
    s = jnp.asarray(convert.rounds_state_to_jax(state))
    for r in range(2):
        s = jexp._mxu_round_body(s, CF[r % 8], wm, wn, wp, pick, n_sub=1)
    jax_out = _ints(convert.rounds_state_from_jax(np.asarray(s)))
    return jax_out, pr.full_rounds_mxu_plain(state, 2)


def test_mxu_plain_matches_mxu_round_body(mxu_two_rounds):
    jax_out, port = mxu_two_rounds
    got = _ints(port)
    canonical = 0
    for e in range(3):
        for b, (g, j) in enumerate(zip(got[e], jax_out[e])):
            assert g == j % P, (e, b)
            if j < P:
                assert g == j, (e, b)
                canonical += 1
    assert canonical > 300  # most of the 384 values are canonical in JAX


def test_f3_port_subtracts_p_where_jax_does_not(mxu_two_rounds, lanes128):
    """F3: JAX's `_sub_if_ge_16` compares with `_P16`, which is all zeros,
    so some lanes come back as x + p. The port returns x, the mirror's
    value."""
    jax_out, port = mxu_two_rounds
    got = _ints(port)
    _, vals = lanes128
    f3 = [(e, b) for e in range(3) for b in range(128)
          if jax_out[e][b] >= P]
    assert f3, "no lane with JAX's value >= p"
    e, b = f3[0]
    want = pr.full_rounds_py([vals[i][b] for i in range(3)], 2)
    assert jax_out[e][b] == want[e] + P
    assert got[e][b] == want[e]
    assert all(got[i][b] < P for i, b in f3)


# ---------------------------------------------------------------------------
# the plain versions against the bigint mirror, with edge lanes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def edge_state():
    return rounds_cases.edge_lanes()


def _reduction_hits(vals):
    """How many (element, lane) mixes of round 0 give (T + q p) / 2^256 >=
    p, i.e. take the final subtract."""
    _, m = convert.rounds_tables()
    mi = [[int(fr.unpack_np(torch.from_numpy(m[i, j].astype(np.int64))))
           for j in range(3)] for i in range(3)]
    c0 = rounds_cases.round_constants()[0]
    rinv, hits = pow(R, -1, P), 0
    for b in range(len(vals[0])):
        s = [pow(((vals[e][b] + c0[e]) % P) * rinv, 5, P) * R % P
             for e in range(3)]
        for e in range(3):
            t = sum(mi[e][j] * s[j] for j in range(3))
            q = (t % (1 << 256)) * N_PRIME % (1 << 256)
            hits += (t + q * P) >> 256 >= P
    return hits


def test_plain_versions_match_mirror_on_edge_lanes(edge_state):
    state, vals = edge_state
    assert _reduction_hits(vals) > 0  # the real subtract is exercised
    want = _mirror(vals, 3)
    vpu = pr.full_rounds_vpu_plain(state, 3)
    mxu = pr.full_rounds_mxu_plain(state, 3)
    assert _ints(vpu) == want
    assert_same(mxu, vpu)


def test_sbox_preimage_lands_on_the_edge_value(edge_state):
    state, _ = edge_state
    s = pr._ark_pow5(state, 0)
    ev = rounds_cases.edge_values()
    got = _ints(s)
    assert [got[e][len(ev) + i] for i in range(len(ev)) for e in range(3)] \
        == [v for v in ev for _ in range(3)]


@pytest.mark.parametrize("rounds", [0, 1, 9])
def test_plain_versions_match_mirror_on_random_lanes(rounds):
    state, vals = exp_mxu_inkernel.random_state(24)
    want = _mirror(vals, rounds)
    assert _ints(pr.full_rounds_vpu_plain(state, rounds)) == want
    assert _ints(pr.full_rounds_mxu_plain(state, rounds)) == want


def test_wrappers_take_plain_on_cpu_and_refuse_other_devices():
    state, _ = exp_mxu_inkernel.random_state(5)
    assert_same(pr.full_rounds_vpu(state, 2),
                pr.full_rounds_vpu_plain(state, 2))
    assert_same(pr.full_rounds_mxu(state, 2),
                pr.full_rounds_mxu_plain(state, 2))
    meta = torch.zeros((16, 3, 4), dtype=torch.int64, device="meta")
    for fn in (pr.full_rounds_vpu, pr.full_rounds_mxu):
        with pytest.raises(ValueError):
            fn(meta, 1)


def test_entry_draws_the_jax_scripts_state(jexp):
    """random_state(B) is the JAX script's data: default_rng(5), one
    integer below 2^62 per (element, lane), times R mod p."""
    state, vals = exp_mxu_inkernel.random_state(40)
    rng = np.random.default_rng(5)
    want = [[int(rng.integers(0, 1 << 62)) * jexp.MONT_R % P
             for _ in range(40)] for _ in range(3)]
    assert vals == want
    assert _ints(state) == want


def test_entry_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        exp_mxu_inkernel.run(8, 1)


# ---------------------------------------------------------------------------
# K6's step order, mirrored in Python integers (csrc/poseidon_rounds.cu)
# ---------------------------------------------------------------------------
#
# The kernel runs only on the card. This mirror follows it step by step:
# which word of X each thread's A fragment takes, where each register of
# mma.m16n8k32 sits in its tile (the layout the source comment states), the
# fold of four byte columns into a word and of four words into a quarter,
# the swizzled V tile, the 16-word carry chain and the eight word rows of
# the reduction, every 32-bit operation wrapped as the card wraps it.

M32 = (1 << 32) - 1
P_WORDS = [(P >> (32 * k)) & M32 for k in range(8)]
FR_N0 = 0xEFFFFFFF


def _a_pos(lane, i, byte):
    """(row, depth) of byte `byte` of A register i of thread `lane`."""
    g, c = lane >> 2, lane & 3
    return g + 8 * (i & 1), 4 * c + byte + 16 * (i >> 1)


def _b_pos(lane, i, byte):
    """(depth, column) of byte `byte` of B register i of thread `lane`."""
    g, c = lane >> 2, lane & 3
    return 16 * i + 4 * c + byte, g


def _d_pos(lane, i):
    """(row, column) of D register i of thread `lane`."""
    g, c = lane >> 2, lane & 3
    return g + 8 * (i >> 1), 2 * c + (i & 1)


def _fold_word(c0, c1, c2, c3):
    """fold_word: mad.lo, then mad.lo.cc / madc.hi twice."""
    x = (c1 * 256 + c0) & M32
    p2, p3 = c2 * 65536, c3 * 16777216
    t = x + (p2 & M32)
    lo, cc = t & M32, t >> 32
    hi = ((p2 >> 32) + cc) & M32
    t = lo + (p3 & M32)
    lo, cc = t & M32, t >> 32
    hi = ((p3 >> 32) + hi + cc) & M32
    return lo, hi


def _add_chain(xs, ys):
    """add.cc, addc.cc, ...: word sums and the carry out."""
    out, cc = [], 0
    for x, y in zip(xs, ys):
        t = x + y + cc
        out.append(t & M32)
        cc = t >> 32
    return out, cc


def _quarter_words(lo, hi):
    words, cc = _add_chain(lo[1:] + [hi[3]], hi[:3] + [0])
    # the chain's last step is addc.u32 v4, hi3, 0
    return [lo[0]] + words[:3] + [words[3]]


def _join_quarters(t, h):
    """join_quarters: quarter q's top word h[q] added at word 4q + 4;
    mod 2^512."""
    add = [0] * 12
    add[0], add[4], add[8] = h[0], h[1], h[2]
    words, _ = _add_chain(t[4:], add)
    return t[:4] + words


def _mad_pairs(x, top, cs, m):
    """fr_mad_pairs: x += cs[0] m + cs[1] m 2^64 + ..., carry into top."""
    x, cc = list(x), 0
    for k, cw in enumerate(cs):
        prod = cw * m
        for w, part in ((2 * k, prod & M32), (2 * k + 1, prod >> 32)):
            t = x[w] + part + cc
            x[w], cc = t & M32, t >> 32
    return x, (top + cc) & M32


def _reduce_once(t, top):
    v = sum(w << (32 * k) for k, w in enumerate(t))
    keep = top == 0 and v < P
    return v if keep else (v - P) % (1 << 256), not keep


def _mont_reduce_wide(t):
    """mont_reduce_wide on 16 words: (the canonical value, whether the
    final subtract took p)."""
    a = list(t[:8])
    for _ in range(8):
        m = (a[0] * FR_N0) & M32
        a, top = _mad_pairs(a, 0, P_WORDS[0::2], m)
        assert a[0] == 0
        a, none = _mad_pairs(a[1:] + [top], 0, P_WORDS[1::2], m)
        assert none == 0
    s, c = _add_chain(a, list(t[8:]))
    return _reduce_once(s, c)


def _words(v, n):
    return [(v >> (32 * k)) & M32 for k in range(n)]


def _lane_T(quarters):
    """quarters[q][u] = the four byte columns the thread in place q of a
    quad folds into its word u (fold_word's argument order) -> T's 16
    words, through quarter_words and join_quarters."""
    vs = []
    for q in range(4):
        lohi = [_fold_word(*quarters[q][u]) for u in range(4)]
        vs.append(_quarter_words([x for x, _ in lohi], [y for _, y in lohi]))
    t = [w for v in vs for w in v[:4]]
    return _join_quarters(t, [v[4] for v in vs])


def _quarters_of_columns(cols):
    """The fold arguments of one lane row from its 64 byte columns, by
    `convert.mix_byte_column` (n-tiles 2u and 2u + 1, registers 2c and
    2c + 1 of each)."""
    return [[[cols[convert.mix_byte_column(2 * u + h, 2 * q + i)]
              for h in range(2) for i in range(2)] for u in range(4)]
            for q in range(4)]


@pytest.fixture(scope="module")
def b_tiles():
    """Wm^T's B tiles (32 x 8) for every (element, n-tile, k-step), read
    back from `convert.mix_fragments` through the B fragment layout."""
    frag = convert.mix_fragments()
    tiles = np.full((3, 8, 3, 32, 8), -1, dtype=np.int64)
    for lane in range(32):
        for i in range(2):
            for byte in range(4):
                k, n = _b_pos(lane, i, byte)
                tiles[:, :, :, k, n] = (frag[:, :, :, lane, i] >> (8 * byte)) \
                    & 255
    assert (tiles >= 0).all()  # every entry of every tile was set once
    return tiles


def _mirror_mix(svals, b_tiles):
    """K6's mix on one warp: svals[L] = the three S-box outputs of lane L
    (32 lanes, Montgomery) -> (the new state of each lane, how many values
    took the final subtract)."""
    xs = [[w for e in range(3) for w in _words(svals[L][e], 8)]
          for L in range(32)]
    vlo = [[None] * 48 for _ in range(32)]
    vhi = [[None] * 12 for _ in range(32)]
    for mt in range(2):
        # each thread's A registers: words c and c + 4 of lanes 16mt + g, + 8
        a_regs = [[[xs[16 * mt + (lane >> 2) + 8 * (i & 1)]
                    [8 * j + (lane & 3) + 4 * (i >> 1)] for i in range(4)]
                   for j in range(3)] for lane in range(32)]
        a_tiles = np.full((3, 16, 32), -1, dtype=np.int64)
        for lane in range(32):
            for j in range(3):
                for i in range(4):
                    for byte in range(4):
                        row, k = _a_pos(lane, i, byte)
                        a_tiles[j, row, k] = (a_regs[lane][j][i] >> (8 * byte)) \
                            & 255
        assert (a_tiles >= 0).all()
        for e in range(3):
            # D tiles of the eight n-tiles, each summed over the 3 k-steps
            d = [sum(a_tiles[j] @ b_tiles[e, nt, j] for j in range(3))
                 for nt in range(8)]
            for lane in range(32):
                g, c = lane >> 2, lane & 3
                for row in range(2):
                    regs = [[int(d[2 * u + h][_d_pos(lane, 2 * row + i)])
                             for h in range(2) for i in range(2)]
                            for u in range(4)]
                    lohi = [_fold_word(*regs[u]) for u in range(4)]
                    v = _quarter_words([x for x, _ in lohi],
                                       [y for _, y in lohi])
                    L = 16 * mt + 8 * row + g
                    slot = c ^ ((L >> 1) & 3)
                    assert vlo[L][16 * e + 4 * slot] is None
                    vlo[L][16 * e + 4 * slot:16 * e + 4 * slot + 4] = v[:4]
                    vhi[L][4 * e + c] = v[4]
    out, subtracted = [], 0
    for L in range(32):
        lane_out = []
        for e in range(3):
            t = [w for q in range(4) for w in
                 vlo[L][16 * e + 4 * (q ^ ((L >> 1) & 3)):][:4]]
            T = _join_quarters(t, vhi[L][4 * e:4 * e + 3])
            val, took = _mont_reduce_wide(T)
            lane_out.append(val)
            subtracted += took
        out.append(lane_out)
    return out, subtracted


def _mirror_rounds(vals, rounds, b_tiles):
    """K6 on all lanes of `vals` (3 lists of Montgomery ints): warps of 32
    lanes, the ragged tail on zeros; ARK + x^5 as K5's (the bigint
    mirror's), then the mirrored mix. Returns (values, subtracts)."""
    oc_c = rounds_cases.round_constants()
    lanes = len(vals[0])
    width = -(-lanes // 32) * 32
    s = [[vals[e][b] if b < lanes else 0 for e in range(3)]
         for b in range(width)]
    rinv, subtracted = pow(R, -1, P), 0
    for r in range(rounds):
        c = oc_c[r % 8]
        s = [[pow((x + c[e]) % P * rinv, 5, P) * R % P
              for e, x in enumerate(lane)] for lane in s]
        new = []
        for w in range(0, width, 32):
            out, took = _mirror_mix(s[w:w + 32], b_tiles)
            new += out
            subtracted += took
        s = new
    return [[s[b][e] for b in range(lanes)] for e in range(3)], subtracted


def test_k6_layout_tables_match_the_mma_fragments():
    """The (thread, register) <-> (lane, byte column) tables the kernel
    relies on: each A register's bytes are one little-endian state word;
    every tile entry of A, B and D belongs to exactly one (thread,
    register); and with the column permutation the thread in place c of a
    quad holds bytes 16c .. 16c + 15 of its two rows, word u of them in
    n-tiles 2u, 2u + 1."""
    for tiles, pos, regs, shape in (
            ("A", _a_pos, 4, (16, 32)), ("B", _b_pos, 2, (32, 8))):
        seen = {}
        for lane in range(32):
            for i in range(regs):
                for byte in range(4):
                    seen.setdefault(pos(lane, i, byte), []).append(
                        (lane, i, byte))
        assert len(seen) == shape[0] * shape[1], tiles
        assert all(len(v) == 1 for v in seen.values()), tiles
        for lane in range(32):  # a register's 4 bytes: consecutive depths
            for i in range(regs):
                ks = [pos(lane, i, byte)[1 if tiles == "A" else 0]
                      for byte in range(4)]
                assert ks == list(range(ks[0], ks[0] + 4)) and ks[0] % 4 == 0
    held = {}
    for lane in range(32):
        g, c = lane >> 2, lane & 3
        for nt in range(8):
            for i in range(4):
                row, n = _d_pos(lane, i)
                assert row in (g, g + 8)
                byte = convert.mix_byte_column(nt, n)
                assert 16 * c <= byte < 16 * c + 16
                assert (byte - 16 * c) // 4 == nt // 2
                held.setdefault((row, byte), []).append((lane, nt, i))
    assert len(held) == 16 * 64 and all(len(v) == 1 for v in held.values())


def test_k6_fragments_are_wm_with_permuted_columns(b_tiles):
    wm, _, _ = convert.mix_matrices()
    for e in range(3):
        for nt in range(8):
            for j in range(3):
                for n in range(8):
                    col = convert.mix_byte_column(nt, n)
                    assert np.array_equal(
                        b_tiles[e, nt, j, :, n],
                        wm[e * 64 + col, j * 32:j * 32 + 32])


def _norm_words(cols):
    """`_bytes_norm` of 64 columns as 16 little-endian words."""
    by = pr._bytes_norm(torch.tensor(cols, dtype=torch.int64)[:, None])
    v = sum(int(x) << (8 * k) for k, x in enumerate(by[:, 0]))
    return _words(v, 16)


@pytest.mark.parametrize("case", ["random", "largest", "runs"])
def test_k6_word_carries_equal_bytes_norm(case):
    """The fold and the 16-word carry chain on one lane row's 64 byte
    columns == `_bytes_norm`, mod 2^512: random columns below 2^23, every
    column at its largest value (96 * 255^2), and columns that leave runs
    of 0xFF bytes for a carry to cross."""
    rng = np.random.default_rng({"random": 1, "largest": 2, "runs": 3}[case])
    top = 96 * 255 * 255
    assert top < 1 << 23
    trials = []
    for _ in range(40):
        if case == "random":
            cols = [int(x) for x in rng.integers(0, top + 1, 64)]
        elif case == "largest":
            cols = [top] * 64
        else:
            cols = [255] * 64
            for k in rng.choice(64, 4, replace=False):
                cols[int(k)] = int(rng.integers(256, top + 1))
        trials.append(cols)
    for cols in trials:
        assert _lane_T(_quarters_of_columns(cols)) == _norm_words(cols)


def test_k6_reduction_rows_equal_montgomery():
    """The eight word rows and the high half: T 2^-256 mod p for T below
    3 p^2, at its ends and at random."""
    rng = np.random.default_rng(4)
    ts = [0, 1, 3 * (P - 1) ** 2, (1 << 256) - 1, P * P, (P - 1) << 256]
    ts += [int.from_bytes(rng.bytes(64), "little") % (3 * P * P)
           for _ in range(200)]
    rinv = pow(1 << 256, -1, P)
    for t in ts:
        assert _mont_reduce_wide(_words(t, 16))[0] == t * rinv % P, t


def test_k6_mirror_mix_equals_plain_mix_on_edge_lanes(edge_state, b_tiles):
    """The whole mirrored mix on the S-box outputs of the edge lanes ==
    `_mix_mxu_plain`, and takes the final subtract as often as
    `_reduction_hits` counts."""
    state, vals = edge_state
    s = pr._ark_pow5(state, 0)
    want = _ints(pr._mix_mxu_plain(s))
    got = _ints(s)
    lanes = len(vals[0])
    svals = [[got[e][b] if b < lanes else 0 for e in range(3)]
             for b in range(64)]
    out = []
    subtracted = 0
    for w in (0, 32):
        o, took = _mirror_mix(svals[w:w + 32], b_tiles)
        out += o
        subtracted += took
    assert [[out[b][e] for b in range(lanes)] for e in range(3)] == want
    hits = _reduction_hits(vals)
    assert hits > 0 and subtracted == hits


def test_k6_mirror_mix_equals_plain_mix_on_random_lanes(lanes128, b_tiles):
    state, _ = lanes128
    s = pr._ark_pow5(state, 0)
    got = _ints(s)
    out = []
    for w in range(0, 128, 32):
        out += _mirror_mix([[got[e][b] for e in range(3)]
                            for b in range(w, w + 32)], b_tiles)[0]
    assert [[lane[e] for lane in out] for e in range(3)] == \
        _ints(pr._mix_mxu_plain(s))


@pytest.mark.parametrize("rounds", [0, 1, 9])
def test_k6_mirror_rounds_equal_bigint_mirror(rounds, b_tiles):
    """K6's mirrored rounds on 40 lanes (a warp and a ragged one) ==
    `full_rounds_py` and the plain version."""
    state, vals = exp_mxu_inkernel.random_state(40)
    got, _ = _mirror_rounds(vals, rounds, b_tiles)
    assert got == _mirror(vals, rounds)
    assert got == _ints(pr.full_rounds_mxu_plain(state, rounds))
