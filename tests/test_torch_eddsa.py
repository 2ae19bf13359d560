"""The port's BabyJubJub / EdDSA-Poseidon (K3's plain version on the CPU)
against the JAX package's XLA path and the host curve code: valid and
tampered signatures, disabled lanes, and s >= 2^253, whose verdict is pinned
to the XLA path's (it reads s as 253 bits); edge lanes (A off the curve, A
or R8 the identity, hm = 0, S = 0, every hm digit 15); and kernel K3's
schedule of four threads a lane on the curve's a = 1 form, mirrored in Python
integers, with its comb block. Exact."""

import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuits_tpu.builder import babyjub
from circuits_tpu.field import fr as jfr
from circuits_tpu.field.scalar import P
from circuits_tpu.ops import babyjubjub as jbjj
from circuits_tpu.ops.poseidon_constants import poseidon_py
from circuits_tpu_torch import convert, kernels
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.ops import babyjubjub as bjj
from circuits_tpu_torch.r1cs import witness_check as wc
from circuits_tpu_torch.scripts import eddsa_cases

from torch_compare import assert_same, to_torch

N_KEYS = 3
# lane kinds: the verdict the XLA path and the host verifier give
KINDS = ["valid", "bad_msg", "bad_s", "s_plus_2^253", "s_plus_2^252",
         "disabled_garbage", "s_plus_order"]


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
            elif kind == "s_plus_order":
                row["s"] = s + babyjub.SUB_ORDER
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
    got, want = verdicts
    expect = kind in ("valid", "s_plus_2^253", "disabled_garbage")
    if kind == "s_plus_order":
        # pinned to the JAX package's XLA path, whatever it says
        expect = bool(np.asarray(want)[kinds.index(kind)])
    assert [bool(got[i]) for i, k in enumerate(kinds) if k == kind] == \
        [expect] * N_KEYS


def test_s_plus_sub_order_follows_the_xla_path(lanes, verdicts):
    """s + SUB_ORDER stays below 2^253 for every s below the order, so the
    XLA path reads all of it: the verdict is the XLA path's (it accepts:
    S * B8 is the same point), while the host verifier, like circomlib's,
    refuses S >= order. Neither package makes that check (ROADMAP F2)."""
    kinds, args = lanes
    got, want = verdicts
    idx = [i for i, k in enumerate(kinds) if k == "s_plus_order"]
    s = [int(v) for v in jfr.unpack_np(args["s"])]
    for i in idx:
        assert babyjub.SUB_ORDER <= s[i] < 1 << 253
        assert bool(got[i]) == bool(np.asarray(want)[i]) is True
        sig = dict(R8=(int(jfr.unpack_np(args["r8x"])[i]),
                       int(jfr.unpack_np(args["r8y"])[i])), S=s[i])
        pub = (int(jfr.unpack_np(args["ax"])[i]),
               int(jfr.unpack_np(args["ay"])[i]))
        assert not babyjub.verify_poseidon(
            int(jfr.unpack_np(args["msg"])[i]), sig, pub)


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


def _ay_sign_lanes():
    """(pts, ays, signs): on-curve points' y values and y values that are
    not, then AySign2Ax's edge lanes (`eddsa_cases.ay_sign_lanes`: y = 0, 1
    and p - 1, y values whose x^2 is a non-residue, each with both signs)."""
    rng = np.random.default_rng(5)
    pts = [babyjub.mul_point(int(k), babyjub.BASE8)
           for k in rng.integers(1, 2**60, size=6)]
    ays = [p[1] for p in pts] + [int(v) for v in rng.integers(2, 2**60, 4)]
    signs = [i % 2 for i in range(len(ays))]
    edge_ays, edge_signs = eddsa_cases.ay_sign_lanes(random.Random(5), 12)
    return pts, ays + edge_ays, signs + edge_signs


def test_ay_sign_to_ax_matches_jax():
    pts, ays, signs = _ay_sign_lanes()
    signs = np.array(signs, np.uint32)
    ay = jfr.pack_np(ays)
    got = bjj.ay_sign_to_ax(to_torch(ay), to_torch(signs).bool())
    assert_same(got, jbjj.jay_sign_to_ax(ay, signs.astype(bool)))
    for i, p in enumerate(pts):
        x = int(fr.unpack_np(got[0])[i])
        assert x in (p[0], (P - p[0]) % P) and bool(got[1][i])
    # the host's scalar version on every lane (no y has den = 0: A / D is a
    # non-residue)
    want = [wc._ay_sign_to_ax(y, int(sg)) for y, sg in zip(ays, signs)]
    assert [(int(x), bool(k)) for x, k in zip(
        fr.unpack_np(got[0]), got[1].tolist())] == want
    assert {k for _, k in want} == {True, False}


def test_ay_sign_wrapper_takes_the_plain_version_on_cpu(monkeypatch):
    """CPU tensors go to `ay_sign_to_ax_plain` as they are (a stub here, so
    nothing is computed); another device, a shape or a dtype the kernel does
    not take raise."""
    seen = []
    monkeypatch.setattr(bjj, "ay_sign_to_ax_plain",
                        lambda ay, sign: seen.append((ay, sign)) or "plain")
    ay = torch.zeros((16, 3), dtype=torch.int64)
    sign = torch.zeros((3,), dtype=torch.bool)
    assert bjj.ay_sign_to_ax(ay, sign) == "plain"
    assert seen[0][0] is ay and seen[0][1] is sign
    bad = [(ay.to("meta"), sign.to("meta"), ValueError),
           (ay[:, :2], sign, ValueError),
           (ay[:15], sign, ValueError),
           (ay.int(), sign, TypeError),
           (ay, sign.long(), TypeError),
           (ay, sign[:2], ValueError),
           (ay.T.contiguous().T, sign, ValueError)]
    for a, sg, err in bad:
        with pytest.raises(err):
            bjj.ay_sign_to_ax(a, sg)
    assert len(seen) == 1


# ---- the AySign2Ax kernel's steps, mirrored in Python integers ---------------
#
# csrc/ay_sign.cu walks a lane in one thread on Montgomery words. The mirror
# takes its constants from the source itself and its steps in the kernel's
# order: the powers least significant bit first with both products a step,
# a^Q and a^((Q + 1) / 2) from one power a^((Q - 1) / 2), Tonelli-Shanks
# with r c and c^2 formed ahead of b.

AY_SIGN_CU = (kernels.CSRC / "ay_sign.cu").read_text()
MONT_R = 1 << 256


def _cu_words(name):
    body = re.search(rf"__constant__ uint32_t {name}\[8\] = \{{([^}}]*)\}};",
                     AY_SIGN_CU).group(1)
    words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
    assert len(words) == 8
    return sum(w << (32 * k) for k, w in enumerate(words))


def _cu_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         AY_SIGN_CU).group(1))


def _mm(a, b):
    return a * b * pow(MONT_R, -1, P) % P


def _mirror_pow(a, e, nbits):
    acc, base = MONT_R % P, a
    for i in range(nbits):
        prod, base = _mm(acc, base), _mm(base, base)
        acc = prod if (e >> i) & 1 else acc
    return acc


def _mirror_ay_sign(ay, sign):
    """`ay_sign_to_ax_kernel` for one lane."""
    one = MONT_R % P
    u = _mm(ay, MONT_R * MONT_R % P)
    u = _mm(u, u)
    num = (one - u) % P
    den = (_cu_words("AS_A_M") - _mm(_cu_words("AS_D_M"), u)) % P
    den_zero = den == 0
    den = one if den_zero else den
    a = _mm(num, _mirror_pow(den, _cu_words("AS_EXP_INV"),
                             _cu_int("AS_EXP_INV_BITS")))
    z = a == 0
    a = one if z else a
    w = _mirror_pow(a, _cu_words("AS_EXP_HALF"), _cu_int("AS_EXP_HALF_BITS"))
    r = _mm(w, a)
    t = _mm(w, r)
    c = _cu_words("AS_ROOT_M")
    for i in range(_cu_int("AS_TWO_ADICITY"), 1, -1):
        u, c = _mm(r, c), _mm(c, c)
        b = t
        for _ in range(i - 2):
            b = _mm(b, b)
        r = r if b == one else u
        u = _mm(t, c)
        t = t if b == one else u
    found = _mm(r, r) == a and not z
    r = _mm(r, 1)
    r = 0 if z or not found else r
    r = min(r, (P - r) % P)
    r = (P - r) % P if sign else r
    return r, (found or z) and not den_zero


def test_ay_sign_kernel_constants():
    """The source's exponents, curve constants and root of unity are the
    values the plain version uses; no __global__ name holds a name by which
    the benchmark counts K1-K4 (it counts this kernel with the field ops)."""
    q = (P - 1) >> 28
    assert _cu_int("AS_TWO_ADICITY") == 28 and q % 2 == 1
    assert _cu_words("AS_EXP_INV") == P - 2
    assert _cu_int("AS_EXP_INV_BITS") == (P - 2).bit_length()
    assert _cu_words("AS_EXP_HALF") == (q - 1) // 2
    assert _cu_int("AS_EXP_HALF_BITS") == ((q - 1) // 2).bit_length()
    assert _cu_words("AS_A_M") == babyjub.A * MONT_R % P
    assert _cu_words("AS_D_M") == babyjub.D * MONT_R % P
    root = pow(5, q, P)
    assert pow(5, (P - 1) // 2, P) == P - 1
    assert _cu_words("AS_ROOT_M") == root * MONT_R % P
    # A / D is a non-residue: no y makes den = 0
    assert pow(babyjub.A * pow(babyjub.D, -1, P) % P, (P - 1) // 2, P) \
        == P - 1
    names = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                       r"\s+(\w+)\(", AY_SIGN_CU)
    assert names == ["ay_sign_to_ax_kernel"]
    for k in ("poseidon_permute_kernel", "smt_chain_kernel", "eddsa_kernel",
              "sha256_chain"):
        assert k not in names[0]


def test_ay_sign_kernel_mirror_equals_host():
    """The kernel's steps give the host's AySign2Ax on every lane kind."""
    _, ays, signs = _ay_sign_lanes()
    more_ays, more_signs = eddsa_cases.ay_sign_lanes(random.Random(17), 24)
    for y, sg in zip(ays + more_ays + [P - 2], signs + more_signs + [1]):
        assert _mirror_ay_sign(y, sg) == wc._ay_sign_to_ax(y, sg), (y, sg)


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



def _jax_ok_given_hm(ax, ay, s, r8x, r8y, hm):
    """The XLA path of the JAX package's `eddsa_poseidon_verify`
    (S * B8 - R8 - hm * A summed to the identity), with hm given and not
    hashed."""
    coords = jfr.to_mont(jnp.concatenate([ax, ay, r8x, r8y], axis=-1))
    n = ax.shape[-1]
    a_pt = jbjj.from_affine_mont(coords[..., :n], coords[..., n:2 * n])
    r8_pt = jbjj.from_affine_mont(coords[..., 2 * n:3 * n],
                                  coords[..., 3 * n:])
    lx, ly, lz = jbjj._base8_points(jfr.bits_le(s, 253))
    vx, vy, vz = jbjj._var_points(jfr.bits_le(hm, 254), a_pt)
    neg_x = jfr.neg(jnp.concatenate([vx, r8_pt[0][:, None]], axis=1))
    x = jnp.concatenate([lx, neg_x], axis=1)
    y = jnp.concatenate([ly, vy, r8_pt[1][:, None]], axis=1)
    z = jnp.concatenate([lz, vz, r8_pt[2][:, None]], axis=1)
    tx, ty, tz = jbjj._sum_points((x, y, z))
    return jfr.is_zero(tx) & jfr.eq(ty, tz)


@pytest.fixture(scope="module")
def edge_verdicts():
    edge = eddsa_cases.edge_lanes(random.Random(41))
    cols = [jfr.pack_np([row[k] for _, row, _ in edge]) for k in range(6)]
    want = np.asarray(jax.jit(_jax_ok_given_hm)(*map(jnp.asarray, cols)))
    ax, ay, s, r8x, r8y, hm = (to_torch(c) for c in cols)
    m = [fr.to_mont(c).contiguous() for c in (ax, ay, r8x, r8y)]
    got = bjj.eddsa_ok_mont(m[0], m[1], s, m[2], m[3], hm)
    return edge, got.tolist(), want.tolist()


@pytest.mark.parametrize("lane", range(13))
def test_edge_lane_matches_jax_and_host(edge_verdicts, lane):
    """A off the curve, A or R8 the identity, hm = 0, S = 0 and every hm
    digit below the top one 15, each with a wrong twin, and S + order: the
    port's verdict is the JAX package's, and the host curve code's where it
    has one."""
    edge, got, want = edge_verdicts
    assert len(edge) == 13
    name, _, host = edge[lane]
    assert got[lane] == want[lane], name
    assert host is None or got[lane] == host, name


# ---- kernel K3's schedule, mirrored thread by thread ------------------------
#
# csrc/eddsa.cu runs a lane on a group of four threads, on the curve's a = 1
# form (x' = sqrt(a) x, d' = d / a). A step is one product in every thread; the
# tables say which product a thread forms at which step (None: the thread's
# product is not used; "_f" marks the fixed-base mixed add, whose sum thread
# 3 holds). The mirror below holds every value as a list of four, one a
# thread, moves values between threads only by `_sh` and `_bc` (a warp
# shuffle inside the group) and multiplies only in `_Group.step`, which
# records the sequence of steps. What only thread 3 holds is poisoned in the
# other three threads, so a wrong source thread fails here.

DBL_STEPS = (  # thread 0, 1, 2, 3; F = C + D, G = C - D, J = F - 2 H
    ("D1", ("X*Y", "Y*Y", "Z*Z", "X*X")),        # M, D, H, C
    ("D2", ("2M*J", "F*G", "F*J", "fix")),       # X', Y', Z'
)
ADD_STEPS = (  # F = B - E, G = B + E, U = T - C - D, V = D - C
    ("A1", ("X1*X2", "Y1*Y2", "Z1*Z2", "S1*S2")),  # C, D, A, T
    ("A2", ("C*D", "fix", "A*A", "fix")),          # CD, B
    ("A3", ("CD*d'", "fix", "fix", "fix")),        # E
    ("A4", ("A*F", "A*G", "F*G", "fix")),          # AF, AG, Z'
    ("A5", ("AF*U", "AG*V", "fix", None)),         # X', Y'
)
FIX_SLOTS = {  # where the fixed-base mixed add's products ride
    ("D2", 0): ("FX*px",), ("D2", 1): ("FY*py",),          # C_f, D_f
    ("D2", 2): ("FZ*FZ",), ("D2", 3): ("FX*FY",),          # B_f, W_f
    "A2": ("(FX+FY)*(px+py)", "W_f*kc"),                   # T_f, E_f
    "A3": ("FZ*F_f", "FZ*G_f", "F_f*G_f"),                 # AF_f, AG_f, Z'_f
    "A4": ("AF_f*U_f",), "A5": ("AG_f*V_f",),              # X'_f, Y'_f
}
K3_STEPS = 1 + 14 * 5 + 64 * (4 * 2 + 5) + 1 + 5 + 1
ROOT_A, D1 = convert.bjj_a1_constants()


def _useful(steps):
    return sum(sum(p is not None and p != "fix" for p in row)
               for _, row in steps)


def test_schedule_tables_count_the_formulas_products():
    """In the a = 1 form a doubling is 7 products, a unified add 12, and the
    mixed add with the comb's third column 11, which exactly fill the free
    slots of a window's four doublings and its add."""
    assert _useful(DBL_STEPS) == 7 and _useful(ADD_STEPS) == 12
    assert sum(len(row) for row in FIX_SLOTS.values()) == 11
    free = 4 * sum(row.count("fix") for _, row in DBL_STEPS) + sum(
        row.count("fix") for _, row in ADD_STEPS)
    assert free == 11
    for name, row in ADD_STEPS:
        assert row.count("fix") == len(FIX_SLOTS.get(name, ()))
    assert K3_STEPS == 910


class _Group:
    """Four threads; `log` records the name of every step."""

    def __init__(self):
        self.log = []

    def step(self, name, a, b):
        self.log.append(name)
        return [x * y % P for x, y in zip(a, b)]


def _sh(x, src):
    return [x[j] for j in src]


def _bc(x, j):
    return [x[j]] * 4


def _add(a, b):
    return [(x + y) % P for x, y in zip(a, b)]


def _sub(a, b):
    return [(x - y) % P for x, y in zip(a, b)]


def _sel(cond, a, b):
    return [x if c else y for c, x, y in zip(cond, a, b)]


_IS = [[i == j for i in range(4)] for j in range(4)]  # _IS[j][i]: i == j
_POISON = random.Random(99)


def _th3(value):
    """A value only thread 3 holds: the other threads' copies are noise."""
    return [_POISON.randrange(P) for _ in range(3)] + [value]


def _sum_xy(v):
    s = _add(_bc(v, 0), _bc(v, 1))
    return _sel(_IS[3], s, v)


def _affine(x, y):
    """Column c of the addend (x, y, 1, x + y) in thread c."""
    return [x, y, 1, (x + y) % P]


def _k3_add(g, v, q, fix=None):
    """`k3_add`: v = (X1, Y1, Z1, S1) + q = (X2, Y2, Z2, S2); with `fix` the
    fixed-base add's last seven products in the free slots."""
    kd = [D1] * 4
    p1 = g.step("A1", v, q)
    sw = _sh(p1, [1, 0, 2, 3])
    a, b = p1, _sel(_IS[0], sw, p1)
    if fix:
        t = _bc(_add(fix["x"], fix["y"]), 3)
        a = _sel(_IS[3], fix["w"], _sel(_IS[1], t, a))
        b = _sel(_IS[3], fix["kc"], _sel(_IS[1], fix["ps"], b))
    p2 = g.step("A2", a, b)
    a, b = p2, kd
    if fix:
        f = _bc(_sub(fix["b"], p2), 3)
        gg = _bc(_add(fix["b"], p2), 3)
        fz = _bc(fix["z"], 3)
        a = _sel(_IS[3], f, _sel(_IS[0], a, fz))
        b = _sel(_IS[0], kd, _sel(_IS[1], f, gg))
    p3 = g.step("A3", a, b)
    a, b = _bc(p2, 2), _bc(p3, 0)
    f, gg = _sub(a, b), _add(a, b)
    t = _bc(p1, 2)
    a, b = _sel(_IS[2], f, t), _sel(_IS[0], f, gg)
    if fix:
        u = _sub(_sub(_bc(p2, 1), fix["c"]), fix["d"])
        a = _sel(_IS[3], _bc(p3, 1), a)
        b = _sel(_IS[3], u, b)
    p4 = g.step("A4", a, b)
    a = _sub(_sub(_bc(p1, 3), p1), _bc(p1, 1))
    b = _sel(_IS[0], a, _sub(p1, sw))
    a = p4
    if fix:
        t = _bc(_sub(fix["d"], fix["c"]), 3)
        a = _sel(_IS[2], p3, a)
        b = _sel(_IS[2], t, b)
    p5 = g.step("A5", a, b)
    if fix:
        fix.update(x=p4, y=_bc(p5, 2), z=p3)
    return _sel(_IS[2], p4, p5)


def _k3_window(g, v, fix, comb3, tab_entry):
    """One window of the kernel's main loop: four doublings of v with the
    first four products of the mixed add fix += comb entry in thread 3's free
    slot (comb3 = the entry's px', py, kc), then v += tab_entry (its four
    columns) with the other seven."""
    px, py, kc = ([c] * 4 for c in comb3)  # every thread loads them
    for k in range(4):
        if k == 0:
            fa, fb = fix["x"], px
        elif k == 1:
            fa, fb = fix["y"], py
        elif k == 2:
            fa, fb = fix["z"], fix["z"]
        else:
            fa, fb = fix["x"], fix["y"]
            fix.update(ps=_add(px, py), kc=kc)
        u = _sh(v, [1, 1, 2, 0])
        p1 = g.step("D1", _sel(_IS[3], u, v), u)
        cc, dd, hh = _bc(p1, 3), _bc(p1, 1), _bc(p1, 2)
        f = _add(cc, dd)
        hh = _add(hh, hh)
        b = _sub(_sel(_IS[1], cc, f), _sel(_IS[1], dd, hh))
        a = _sel(_IS[0], _add(p1, p1), f)
        v = g.step("D2", _sel(_IS[3], fa, a), _sel(_IS[3], fb, b))
        fix["cdbw"[k]] = v
    v = _k3_add(g, _sum_xy(v), tab_entry, fix)
    return v


def _new_fix(x, y, z):
    return dict(x=_th3(x), y=_th3(y), z=_th3(z))


def _affine_of(x, y, z):
    """The affine point of the twisted curve behind the a = 1 form's
    projective (X', Y, Z)."""
    zi = pow(z, -1, P)
    return (x * zi * pow(ROOT_A, -1, P) % P, y * zi % P)


def _mapped_projective(rng, k):
    """k * BASE8 in the a = 1 form, with a random Z."""
    x, y = babyjub.mul_point(k, babyjub.BASE8)
    z = rng.randrange(1, P)
    return [ROOT_A * x * z % P, y * z % P, z]


def _comb3(pt):
    x1 = ROOT_A * pt[0] % P
    return (x1, pt[1], D1 * x1 * pt[1] % P)


@pytest.mark.parametrize("case", ["doubling", "add", "mixed_add"])
def test_kernel_schedule_mirror_matches_host_curve(case):
    """One window of K3's schedule against the host curve code: the four
    doublings and the table add of the variable-base walk (var' = 16 var +
    T), and the mixed add in their free slots (fix' = fix + comb entry)."""
    rng = random.Random(31)
    g = _Group()
    var = _mapped_projective(rng, 1234567)
    fxyz = _mapped_projective(rng, 7654321)
    fix = _new_fix(*fxyz)
    t_aff = babyjub.mul_point(11, babyjub.BASE8)
    tz = rng.randrange(1, P)
    tx, ty = ROOT_A * t_aff[0] * tz % P, t_aff[1] * tz % P
    entry = [tx, ty, tz, (tx + ty) % P]
    comb = babyjub.mul_point(5 << 40, babyjub.BASE8)
    if case == "doubling":
        entry = [0, 1, 1, 1]  # the table's entry 0: the identity
    v2 = _k3_window(g, var + [0], fix, _comb3(comb), entry)
    want_var = babyjub.mul_point(16, _affine_of(*var))
    if case == "doubling":
        assert _affine_of(*v2[:3]) == want_var
    elif case == "add":
        assert _affine_of(*v2[:3]) == babyjub.add_point(want_var, t_aff)
    else:
        got = _affine_of(fix["x"][3], fix["y"][3], fix["z"][3])
        assert got == babyjub.add_point(_affine_of(*fxyz), comb)
    assert g.log == ["D1", "D2"] * 4 + ["A1", "A2", "A3", "A4", "A5"]


def _plain_formulas_window(var, fix, comb, entry):
    """The plain version's twisted formulas (`bjj.pdouble`, `bjj.padd`) in
    Python integers, one value at a time."""
    def dbl(p):
        x, y, z = p
        b, c, d, h = (x + y) ** 2, x * x, y * y, z * z
        e = babyjub.A * c
        f = e + d
        j = f - 2 * h
        return ((b - c - d) * j % P, f * (e - d) % P, f * j % P)

    def add(p, q):
        az = p[2] * q[2]
        bb, c, d = az * az, p[0] * q[0], p[1] * q[1]
        t = (p[0] + p[1]) * (q[0] + q[1])
        e = babyjub.D * c * d
        f, g = bb - e, bb + e
        return (az * f * (t - c - d) % P,
                az * g * (d - babyjub.A * c) % P, f * g % P)

    v = tuple(var)
    for _ in range(4):
        v = dbl(v)
    return add(v, entry), add(tuple(fix), (comb[0], comb[1], 1))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_a1_schedule_equals_twisted_formulas_off_the_curve(seed):
    """The a = 1 formulas on mapped inputs give the mapped outputs of the
    plain version's twisted formulas, (sqrt(a) X, Y, Z) word for word, for
    any X, Y, Z, on the curve or not."""
    rng = random.Random(seed)
    var = [rng.randrange(P) for _ in range(3)]
    fxyz = [rng.randrange(P) for _ in range(3)]
    if seed == 1:
        var, fxyz = [0, 1, 1], [0, 1, 1]  # both walks start here
    comb = (rng.randrange(P), rng.randrange(P))
    entry = [rng.randrange(P) for _ in range(3)]

    def mapped(p):
        return [ROOT_A * p[0] % P, p[1], p[2]]

    m_entry = mapped(entry)
    m_entry.append((m_entry[0] + m_entry[1]) % P)
    fix = _new_fix(*mapped(fxyz))
    v2 = _k3_window(_Group(), mapped(var) + [0], fix, _comb3(comb), m_entry)
    want_v, want_f = _plain_formulas_window(var, fxyz, comb, entry)
    assert v2[:3] == mapped(want_v)
    assert [fix[k][3] for k in "xyz"] == mapped(want_f)


def _words_int(words):
    return sum(int(w) << (32 * n) for n, w in enumerate(words))


def test_a1_comb_block_matches_host_table():
    """`convert.eddsa_kernel_words`: entry (j, d) is (sqrt(a) x, y,
    (d / a) sqrt(a) x y) of the host's d * 16^j * BASE8, entry by entry, then
    sqrt(a) and d / a; all in Montgomery form."""
    assert ROOT_A * ROOT_A % P == babyjub.A
    assert D1 * babyjub.A % P == babyjub.D
    # d / a is no square, so the a = 1 form's addition law is complete
    assert pow(D1, (P - 1) // 2, P) == P - 1
    words = convert.eddsa_kernel_words()
    assert words.shape == (convert.COMB_ELEMS + 2, 8)
    r = 1 << 256
    base = babyjub.BASE8
    for j in range(64):
        pt = babyjub.IDENTITY
        for d in range(16):
            got = [_words_int(words[(j * 16 + d) * 3 + c]) for c in range(3)]
            assert got == [v * r % P for v in _comb3(pt)], (j, d)
            pt = babyjub.add_point(pt, base)
        base = babyjub.mul_point(16, base)
    assert [_words_int(w) for w in words[-2:]] == [ROOT_A * r % P,
                                                   D1 * r % P]


def _k3_verdict(ax, ay, s, r8x, r8y, hm):
    """The whole kernel for one lane on its own constant block: Ax and R8x
    mapped, the table of d * A', 64 windows, the add of R8' and the
    projective comparison; returns (verdict, steps)."""
    g = _Group()
    rinv = pow(1 << 256, -1, P)
    block = [_words_int(w) * rinv % P for w in convert.eddsa_kernel_words()]
    root = [block[convert.COMB_ELEMS]] * 4
    assert block[convert.COMB_ELEMS + 1] == D1
    ident = [0, 1, 1, 1]
    q = _affine(g.step("MAP", [ax] * 4, root)[0], ay)
    v = list(q)
    tab = [ident, v]
    for _ in range(2, 16):
        v = _sum_xy(_k3_add(g, v, q))
        tab.append(v)
    v, fix = ident, _new_fix(0, 1, 1)
    for jj in range(63, -1, -1):
        dh = (hm >> (4 * jj)) & 15
        ds = (s >> (4 * jj)) & 15
        if jj == 63:
            ds &= 1
        e = (jj * 16 + ds) * 3
        v = _k3_window(g, v, fix, block[e:e + 3], tab[dh])
    q = _affine(g.step("MAP", [r8x] * 4, root)[0], r8y)
    v = _k3_add(g, _sum_xy(v), q)
    fv = _sel(_IS[2], _bc(fix["y"], 3),
              _sel(_IS[0], _bc(fix["x"], 3), _bc(fix["z"], 3)))
    cmp = g.step("CMP", _sh(v, [2, 0, 2, 1]), fv)
    eq = [x == y for x, y in zip(cmp, _sh(cmp, [1, 0, 3, 2]))]
    return all(eq), len(g.log)


@pytest.mark.parametrize("kind", ["valid", "bad_msg", "s_plus_2^253",
                                  "s_plus_2^252"])
def test_kernel_schedule_mirror_whole_lane(kind):
    rng = np.random.default_rng(12)
    prv = rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()
    ax, ay = babyjub.prv2pub(prv)
    msg = 987654321
    sig = babyjub.sign_poseidon(prv, msg)
    s, (r8x, r8y) = sig["S"], sig["R8"]
    if kind == "bad_msg":
        msg += 1
    elif kind == "s_plus_2^253":
        s += 1 << 253
    elif kind == "s_plus_2^252":
        s += 1 << 252
    hm = poseidon_py([r8x, r8y, ax, ay, msg])
    ok, steps = _k3_verdict(ax, ay, s, r8x, r8y, hm)
    assert ok == (kind in ("valid", "s_plus_2^253"))
    assert steps == K3_STEPS


@pytest.mark.parametrize("lane", [1, 2, 4, 6, 8, 10, 12])
def test_kernel_schedule_mirror_edge_lanes(lane):
    """The mirror on edge lanes: A off the curve (the JAX package's verdict),
    A and R8 the identity, hm = 0, S = 0, every hm digit 15, S + order."""
    name, row, host = eddsa_cases.edge_lanes(random.Random(41))[lane]
    ok, _ = _k3_verdict(*row)
    if host is None:
        cols = [jnp.asarray(jfr.pack_np([v])) for v in row]
        host = bool(np.asarray(_jax_ok_given_hm(*cols))[0])
    assert ok == host, name
