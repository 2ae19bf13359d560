"""Host-side BabyJubJub curve + EdDSA-Poseidon (circomlib JS semantics).

Mirrors circomlib's `babyjub.js` / `eddsa.js` — the crypto layer under
@hermeznetwork/commonjs (reference usage: test/lib/utils-bjj.test.js:3-7).

Twisted Edwards curve over BN254 Fr: a*x^2 + y^2 = 1 + d*x^2*y^2,
a = 168700, d = 168696. Base8 is 8x the generator; the prime-order
subgroup has order SUB_ORDER (curve order / 8).
"""

from __future__ import annotations

from .scalar import P, fsqrt
from .poseidon_constants import poseidon_py
from .crypto import blake512

A = 168700
D = 168696

ORDER = 21888242871839275222246405745257275088614511777268538073601725287587578984328
SUB_ORDER = ORDER >> 3

BASE8 = (
    5299619240641551281634865583518297030282874472190772894086521144482721001553,
    16950150798460657717958625567821834550301663161624707787222815936182638968203,
)

IDENTITY = (0, 1)


def add_point(p1, p2):
    """Unified twisted-Edwards addition (complete on BabyJubJub)."""
    x1, y1 = p1
    x2, y2 = p2
    beta = x1 * y2 % P
    gamma = y1 * x2 % P
    delta = (y1 - A * x1) * (x2 + y2) % P
    tau = beta * gamma % P
    dtau = D * tau % P
    x3 = (beta + gamma) * pow(1 + dtau, -1, P) % P
    y3 = (delta + A * beta - gamma) * pow(1 - dtau, -1, P) % P
    return (x3, y3)


# --- extended (Hisil et al. "add-2008-hwcd") coordinates for the scalar
# multiply internals: (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z. One
# inversion per multiply instead of two per ADD — the affine ladder cost
# ~80µs/add in `pow(.., -1, P)` and dominated host signing/population at
# production scale (SCALING.md §2). The unified formula is complete on
# BabyJubJub (a = 168700 is a QR mod p, d = 168696 is not).

_EXT_IDENTITY = (0, 1, 1, 0)


def _to_ext(pt):
    x, y = pt
    return (x, y, 1, x * y % P)


def _from_ext(e):
    x, y, z, _ = e
    zi = pow(z, -1, P)
    return (x * zi % P, y * zi % P)


def _ext_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a_ = x1 * x2 % P
    b_ = y1 * y2 % P
    c_ = D * t1 * t2 % P
    d_ = z1 * z2 % P
    e_ = ((x1 + y1) * (x2 + y2) - a_ - b_) % P
    f_ = (d_ - c_) % P
    g_ = (d_ + c_) % P
    h_ = (b_ - A * a_) % P
    return (e_ * f_ % P, g_ * h_ % P, f_ * g_ % P, e_ * h_ % P)


def _ext_mul(k: int, e):
    acc = _EXT_IDENTITY
    add = e
    while k:
        if k & 1:
            acc = _ext_add(acc, add)
        add = _ext_add(add, add)
        k >>= 1
    return acc


def mul_point(k: int, pt):
    if pt == BASE8:
        return mul_base8(k)
    return mul_point_generic(k, pt)


_BASE8_COMB: list | None = None


def mul_base8(k: int):
    """Fixed-base multiply by BASE8 via an 8-bit comb table (built once):
    ~32 extended-coordinate adds + one inversion instead of ~500 affine
    double+adds. The host signer does two B8 multiplies per signature
    (prv2pub + the nonce point) — the batch-preparation hot path at
    production scale (SCALING.md §2)."""
    global _BASE8_COMB
    if _BASE8_COMB is None:
        tab = []
        base = _to_ext(BASE8)
        for _ in range(32):           # windows of 8 bits
            row = [_EXT_IDENTITY]
            for _ in range(255):
                row.append(_ext_add(row[-1], base))
            tab.append(row)
            base = _ext_mul(256, base)
        _BASE8_COMB = tab
    if k >> 256:
        return mul_point_generic(k, BASE8)
    acc = _EXT_IDENTITY
    for w in range(32):
        d = (k >> (8 * w)) & 0xFF
        if d:
            acc = _ext_add(acc, _BASE8_COMB[w][d])
    return _from_ext(acc)


def mul_point_generic(k: int, pt):
    return _from_ext(_ext_mul(k, _to_ext(pt)))


def in_curve(pt) -> bool:
    x, y = pt
    return (A * x * x + y * y) % P == (1 + D * x * x % P * y * y) % P


def pack_point(pt) -> bytes:
    """circomlib packPoint: 32-byte LE of y, top bit set iff x > (p-1)/2."""
    x, y = pt
    buff = bytearray(y.to_bytes(32, "little"))
    if x > (P - 1) // 2:
        buff[31] |= 0x80
    return bytes(buff)


def unpack_point(buff: bytes):
    """Inverse of pack_point; returns None if not a curve point."""
    sign = bool(buff[31] & 0x80)
    y = int.from_bytes(bytes(buff[:31]) + bytes([buff[31] & 0x7F]), "little")
    if y >= P:
        return None
    # a x^2 + y^2 = 1 + d x^2 y^2  =>  x^2 = (1 - y^2) / (a - d y^2)
    num = (1 - y * y) % P
    den = (A - D * y * y) % P
    if den == 0:
        return None
    x2 = num * pow(den, -1, P) % P
    x = fsqrt(x2)
    if x is None:
        return None
    # fsqrt returns min root; sign selects the "large" root
    if sign:
        x = (P - x) % P
    return (x, y)


# ---------------------------------------------------------------------------
# EdDSA-Poseidon (circomlib eddsa.js)
# ---------------------------------------------------------------------------


def _prune(buff32: bytes) -> bytes:
    b = bytearray(buff32)
    b[0] &= 0xF8
    b[31] &= 0x7F
    b[31] |= 0x40
    return bytes(b)


def prv2scalar(prv: bytes) -> int:
    """Pruned key scalar >> 3 (the scalar multiplying Base8)."""
    h = blake512(prv)
    s = int.from_bytes(_prune(h[:32]), "little")
    return s >> 3


def prv2pub(prv: bytes):
    return mul_point(prv2scalar(prv), BASE8)


def sign_poseidon(prv: bytes, msg: int):
    """Returns dict(R8=(x,y), S=int). msg is a field element."""
    h = blake512(prv)
    s3 = prv2scalar(prv)
    A_pt = mul_point(s3, BASE8)
    r_buff = blake512(h[32:64] + (msg % P).to_bytes(32, "little"))
    r = int.from_bytes(r_buff, "little") % SUB_ORDER
    r8 = mul_point(r, BASE8)
    hm = poseidon_py([r8[0], r8[1], A_pt[0], A_pt[1], msg % P])
    s_sig = (r + hm * s3) % SUB_ORDER
    return {"R8": r8, "S": s_sig}


def verify_poseidon(msg: int, sig: dict, pub) -> bool:
    """Checks the same identity the circuit enforces
    (circomlib EdDSAPoseidonVerifier): S*B8 == R8 + H(R8,A,M)*A."""
    r8 = sig["R8"]
    s_sig = sig["S"]
    if s_sig >= SUB_ORDER:
        return False
    if not (in_curve(r8) and in_curve(pub)):
        return False
    hm = poseidon_py([r8[0], r8[1], pub[0], pub[1], msg % P])
    left = mul_point(s_sig, BASE8)
    right = add_point(r8, mul_point(hm, pub))
    return left == right
