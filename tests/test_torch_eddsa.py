"""The port's BabyJubJub / EdDSA-Poseidon (K3's plain version on the CPU)
against the JAX package's XLA path and the host curve code: valid and
tampered signatures, disabled lanes, and s >= 2^253, whose verdict is pinned
to the XLA path's (it reads s as 253 bits). Exact."""

import numpy as np
import pytest
import torch

from circuits_tpu.builder import babyjub
from circuits_tpu.field import fr as jfr
from circuits_tpu.field.scalar import P
from circuits_tpu.ops import babyjubjub as jbjj
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.ops import babyjubjub as bjj

from torch_compare import assert_same, to_torch

N_KEYS = 3
# lane kinds: the verdict the XLA path and the host verifier give
KINDS = ["valid", "bad_msg", "bad_s", "s_plus_2^253", "s_plus_2^252",
         "disabled_garbage"]


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(77)
    cols = {k: [] for k in ("enabled", "ax", "ay", "s", "r8x", "r8y", "msg")}
    kinds = []
    for i in range(N_KEYS):
        prv = rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()
        ax, ay = babyjub.prv2pub(prv)
        msg = int(rng.integers(0, 2**62)) * (2**180 + i) % P
        sig = babyjub.sign_poseidon(prv, msg)
        s, (r8x, r8y) = sig["S"], sig["R8"]
        for kind in KINDS:
            row = dict(enabled=1, ax=ax, ay=ay, s=s, r8x=r8x, r8y=r8y,
                       msg=msg)
            if kind == "bad_msg":
                row["msg"] = (msg + 1) % P
            elif kind == "bad_s":
                row["s"] = (s + 1) % babyjub.SUB_ORDER
            elif kind == "s_plus_2^253":
                row["s"] = s + (1 << 253)
            elif kind == "s_plus_2^252":
                row["s"] = s + (1 << 252)
            elif kind == "disabled_garbage":
                row.update(enabled=0, s=123, r8x=5, msg=6)
            for k, v in row.items():
                cols[k].append(v)
            kinds.append(kind)
    args = dict(enabled=np.array(cols["enabled"], np.uint32),
                **{k: jfr.pack_np(v) for k, v in cols.items()
                   if k != "enabled"})
    return kinds, args


@pytest.fixture(scope="module")
def verdicts(lanes):
    _, args = lanes
    want = jbjj.jeddsa_poseidon_verify(**args)
    got = bjj.eddsa_poseidon_verify(**{k: to_torch(v)
                                       for k, v in args.items()})
    return got, want


def test_verify_matches_jax(verdicts):
    got, want = verdicts
    assert_same(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_verdict_per_kind(lanes, verdicts, kind):
    kinds, _ = lanes
    got, _ = verdicts
    expect = kind in ("valid", "s_plus_2^253", "disabled_garbage")
    assert [bool(got[i]) for i, k in enumerate(kinds) if k == kind] == \
        [expect] * N_KEYS


def test_valid_lanes_agree_with_host_verifier(lanes, verdicts):
    kinds, args = lanes
    got, _ = verdicts
    unpack = {k: [int(v) for v in jfr.unpack_np(a)] for k, a in args.items()
              if k != "enabled"}
    for i, kind in enumerate(kinds):
        if kind in ("valid", "bad_msg", "bad_s"):
            sig = dict(R8=(unpack["r8x"][i], unpack["r8y"][i]),
                       S=unpack["s"][i])
            host = babyjub.verify_poseidon(
                unpack["msg"][i], sig, (unpack["ax"][i], unpack["ay"][i]))
            assert bool(got[i]) == host, (i, kind)


def test_ay_sign_to_ax_matches_jax():
    rng = np.random.default_rng(5)
    pts = [babyjub.mul_point(int(k), babyjub.BASE8)
           for k in rng.integers(1, 2**60, size=6)]
    # on-curve y values with both signs, then y values that are not
    ays = [p[1] for p in pts] + [int(v) for v in rng.integers(2, 2**60, 4)]
    signs = np.array([i % 2 for i in range(len(ays))], np.uint32)
    ay = jfr.pack_np(ays)
    got = bjj.ay_sign_to_ax(to_torch(ay), to_torch(signs).bool())
    assert_same(got, jbjj.jay_sign_to_ax(ay, signs.astype(bool)))
    for i, p in enumerate(pts):
        x = int(fr.unpack_np(got[0])[i])
        assert x in (p[0], (P - p[0]) % P) and bool(got[1][i])


def test_point_ops_match_host():
    rng = np.random.default_rng(9)
    ks = [int(k) for k in rng.integers(1, 2**50, size=4)]
    pts = [babyjub.mul_point(k, babyjub.BASE8) for k in ks]

    def mont(vals):
        return fr.to_mont(fr.pack(vals))

    one = mont([1] * 4)
    p1 = (mont([p[0] for p in pts]), mont([p[1] for p in pts]), one)
    p2 = tuple(c.flip(-1) for c in p1)  # the same points, lanes reversed

    def affine(p):
        zi = fr.inv(fr.from_mont(p[2]))
        return [(int(x), int(y)) for x, y in zip(
            fr.unpack_np(fr.mul(fr.from_mont(p[0]), zi)),
            fr.unpack_np(fr.mul(fr.from_mont(p[1]), zi)))]

    want_add = [babyjub.add_point(a, b) for a, b in zip(pts, pts[::-1])]
    assert affine(bjj.padd(p1, p2)) == want_add
    assert affine(bjj.padd_affine(p1, (p2[0], p2[1]))) == want_add
    assert affine(bjj.pdouble(p1)) == [babyjub.add_point(a, a) for a in pts]


def test_wrapper_refuses_other_devices():
    x = torch.zeros((16, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        bjj.eddsa_ok_mont(x, x, x, x, x, x)

