"""Host-side (Python bigint) BN254 scalar-field reference arithmetic.

This is the golden oracle for the limb arithmetic in `fr.py`, and the
arithmetic used by the host-side batch builder (this folder).

The field is the BN254/alt_bn128 *scalar* field Fr — the field circom 0.5.x
operates in (reference: the reference's tools/helpers/actions.js:209).
"""

from __future__ import annotations

# BN254 scalar field modulus (reference: tools/helpers/actions.js:209)
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Limb layout used by the device kernels: 16 little-endian limbs x 16 bits.
N_LIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

# Montgomery parameters for R = 2^256
R = (1 << 256) % P
R2 = (R * R) % P
R3 = (R * R2) % P
# -P^{-1} mod 2^LIMB_BITS
N0 = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


def fadd(a: int, b: int) -> int:
    return (a + b) % P


def fsub(a: int, b: int) -> int:
    return (a - b) % P


def fmul(a: int, b: int) -> int:
    return (a * b) % P


def fneg(a: int) -> int:
    return (-a) % P


def finv(a: int) -> int:
    return pow(a, -1, P)


def fpow(a: int, e: int) -> int:
    return pow(a, e, P)


def to_limbs(x: int) -> list[int]:
    """Split a canonical field element into 16 little-endian 16-bit limbs."""
    x %= P
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(N_LIMBS)]


def from_limbs(limbs) -> int:
    v = 0
    for i, limb in enumerate(limbs):
        v += int(limb) << (LIMB_BITS * i)
    return v


# ---------------------------------------------------------------------------
# Square roots (needed for BabyJubJub point decompression).
# p - 1 = 2^28 * Q with Q odd.
# ---------------------------------------------------------------------------
TWO_ADICITY = 28
Q_ODD = (P - 1) >> TWO_ADICITY
assert Q_ODD % 2 == 1 and (Q_ODD << TWO_ADICITY) == P - 1

# Smallest quadratic non-residue (5 for BN254 Fr).
def _find_nonresidue() -> int:
    g = 2
    while pow(g, (P - 1) // 2, P) == 1:
        g += 1
    return g


NONRESIDUE = _find_nonresidue()
# Generator of the 2-Sylow subgroup.
ROOT_OF_UNITY = pow(NONRESIDUE, Q_ODD, P)


def is_square(a: int) -> bool:
    a %= P
    return a == 0 or pow(a, (P - 1) // 2, P) == 1


def fsqrt(a: int) -> int | None:
    """Tonelli-Shanks square root; returns the root r with r <= P - r, or
    None when `a` is a non-residue."""
    a %= P
    if a == 0:
        return 0
    if not is_square(a):
        return None
    # Tonelli-Shanks
    m = TWO_ADICITY
    c = ROOT_OF_UNITY
    t = pow(a, Q_ODD, P)
    r = pow(a, (Q_ODD + 1) // 2, P)
    while t != 1:
        # find least i such that t^(2^i) == 1
        i = 0
        t2 = t
        while t2 != 1:
            t2 = (t2 * t2) % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m = i
        c = (b * b) % P
        t = (t * c) % P
        r = (r * b) % P
    return min(r, P - r)
