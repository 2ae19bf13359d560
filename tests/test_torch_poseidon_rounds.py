"""The full-round experiment's plain versions (K5's and K6's, on the CPU)
against the JAX bodies of scripts/exp_mxu_inkernel.py and the bigint
mirror. Exact everywhere.

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
from circuits_tpu_torch.scripts import exp_mxu_inkernel

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


def _sbox_preimage(y_mont: int, c_mont: int) -> int:
    """The Montgomery value x whose round-0 ARK + x^5 gives the Montgomery
    value y_mont (x^5 permutes Fr, since gcd(5, p - 1) = 1)."""
    rinv = pow(R, -1, P)
    a = pow(y_mont * rinv % P, pow(5, -1, P - 1), P)
    return (a - c_mont * rinv) * R % P


def _edge_values():
    """Canonical values with runs of 0xFF bytes, the field's ends, and
    Montgomery one."""
    runs = [(1 << 248) - 1, (1 << 253) - 1, ((1 << 248) - 1) ^ (0xFF << 120),
            (1 << 253) - (1 << 8), P - 1 - (1 << 200)]
    return [0, 1, P - 1, R % P] + runs


@pytest.fixture(scope="module")
def edge_state():
    cf, _ = convert.rounds_tables()
    c0 = [int(fr.unpack_np(torch.from_numpy(cf[0, e].astype(np.int64))))
          for e in range(3)]
    ev = _edge_values()
    lanes = [[v, v, v] for v in ev]  # the value itself in every element
    # and lanes whose round-0 S-box outputs are those values, so the mix
    # reads byte columns full of 0xFF
    lanes += [[_sbox_preimage(v, c0[e]) for e in range(3)] for v in ev]
    lanes += [[ev[i], ev[(i + 3) % len(ev)], ev[(i + 5) % len(ev)]]
              for i in range(len(ev))]
    rng = np.random.default_rng(21)
    lanes += [[int(v) % P for v in rng.integers(0, 1 << 63, 3)]
              for _ in range(8)]
    vals = [[lane[e] for lane in lanes] for e in range(3)]
    return fr.pack(vals), vals


def _reduction_hits(vals):
    """How many (element, lane) mixes of round 0 give (T + q p) / 2^256 >=
    p, i.e. take the final subtract."""
    cf, m = convert.rounds_tables()
    mi = [[int(fr.unpack_np(torch.from_numpy(m[i, j].astype(np.int64))))
           for j in range(3)] for i in range(3)]
    c0 = [int(fr.unpack_np(torch.from_numpy(cf[0, e].astype(np.int64))))
          for e in range(3)]
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
    n = len(_edge_values())
    got = _ints(s)
    assert [got[e][n + i] for i in range(n) for e in range(3)] == \
        [v for v in _edge_values() for _ in range(3)]


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
