"""Hard inputs for the EdDSA check (kernel K3, ops/babyjubjub.py) and for
AySign2Ax (its kernel in csrc/ay_sign.cu), built from the host curve code:
the same lanes go to the plain version against the JAX package on the CPU,
to the kernel against the plain version on the card
(tests/test_torch_eddsa.py, tests/test_torch_cuda.py) and to chip_smoke.py.
"""

from __future__ import annotations

from ..builder import babyjub
from ..field import fr, scalar


def edge_lanes(rng):
    """K3's edge lanes as (name, (ax, ay, s, r8x, r8y, hm), verdict), all
    integers. hm is given, not hashed, so that it can be 0 or have every
    digit below the top one at its maximum; the verdict is the host curve
    code's, None where it has none (A off the curve). "S + order" is a valid
    signature with the subgroup order added to S (still below 2^253): the
    group equation holds, so the JAX package's XLA path accepts it, and so
    does the port, which follows that path; circomlib's verifier would
    refuse S >= order, a check neither package makes (ROADMAP F2)."""
    order = babyjub.SUB_ORDER
    k, r = rng.randrange(1, order), rng.randrange(1, order)
    a_pt = babyjub.mul_point(k, babyjub.BASE8)
    r_pt = babyjub.mul_point(r, babyjub.BASE8)
    hm = rng.randrange(scalar.P)
    top = (3 << 252) - 1  # digits 2, 15, 15, ...: the largest such hm < p
    ident = babyjub.IDENTITY
    hm_a = babyjub.mul_point(hm, a_pt)
    minus_hm_a = ((-hm_a[0]) % scalar.P, hm_a[1])
    lanes = [
        ("valid", a_pt, (r + hm * k) % order, r_pt, hm, True),
        ("A off the curve", (5, 7), r, r_pt, hm, None),
        ("A = (0, 1)", ident, r, r_pt, hm, True),
        ("A = (0, 1), wrong S", ident, r + 1, r_pt, hm, False),
        ("R8 = (0, 1)", a_pt, hm * k % order, ident, hm, True),
        ("R8 = (0, 1), wrong S", a_pt, (hm * k + 1) % order, ident, hm,
         False),
        ("hm = 0", a_pt, r, r_pt, 0, True),
        ("hm = 0, wrong R8", a_pt, r, a_pt, 0, False),
        ("S = 0", a_pt, 0, minus_hm_a, hm, True),
        ("S = 0, wrong R8", a_pt, 0, r_pt, hm, False),
        ("every hm digit 15", a_pt, (r + top * k) % order, r_pt, top, True),
        ("every hm digit 15, wrong S", a_pt, (r + top * k + 1) % order, r_pt,
         top, False),
        ("S + order", a_pt, (r + hm * k) % order + order, r_pt, hm, True),
    ]
    return [(name, (a[0], a[1], s, r8[0], r8[1], h), verdict)
            for name, a, s, r8, h, verdict in lanes]


def kernel_args(rows, dev):
    """`eddsa_ok_mont`'s arguments for rows of integers (ax, ay, s, r8x,
    r8y, hm): coordinates to Montgomery form, s and hm canonical."""
    ax, ay, s, r8x, r8y, hm = (fr.pack([row[k] for row in rows], dev)
                               for k in range(6))
    m = [fr.to_mont(c).contiguous() for c in (ax, ay, r8x, r8y)]
    return (m[0], m[1], s.contiguous(), m[2], m[3], hm.contiguous())


def _x2(y: int) -> int:
    """AySign2Ax's x^2 = (1 - y^2) / (A - D y^2) (den 0 read as 1)."""
    y2 = y * y % scalar.P
    den = (babyjub.A - babyjub.D * y2) % scalar.P or 1
    return (1 - y2) * pow(den, -1, scalar.P) % scalar.P


def den_zero_y():
    """A y with A - D y^2 = 0, or None: there is one only where A / D is a
    square mod p, and for BabyJubJub it is not."""
    r = babyjub.A * pow(babyjub.D, -1, scalar.P) % scalar.P
    return scalar.fsqrt(r) if scalar.is_square(r) else None


def ay_sign_lanes(rng, lanes):
    """`lanes` lanes of AySign2Ax as (ays, signs), integer lists: first the
    edge lanes, each kind with both signs -- a point's y, y = 1 and p - 1
    (x^2 = 0: the root 0, negated to 0), y = 0 (x^2 = 1 / A), y values whose
    x^2 is a non-residue (ax 0, not ok), the y of `den_zero_y` where there
    is one -- then random field elements with random signs."""
    p = scalar.P
    pt = babyjub.mul_point(rng.randrange(1, babyjub.SUB_ORDER), babyjub.BASE8)
    non = [y for y in range(2, 60) if not scalar.is_square(_x2(y))][:2]
    edge = [pt[1], 1, non[0], 0, p - 1, non[1]]
    if den_zero_y() is not None:
        edge.append(den_zero_y())
    rows = [(y, sign) for sign in (1, 0) for y in edge]
    rows += [(rng.randrange(p), rng.randrange(2))
             for _ in range(max(0, lanes - len(rows)))]
    rows = rows[:lanes]
    return [y for y, _ in rows], [sign for _, sign in rows]
