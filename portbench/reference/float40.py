"""float40 encoding (commonjs `float40` equivalent).

Layout: [ exponent 5 bits | mantissa 35 bits ]; value = mantissa * 10^exp
(reference: the reference's src/lib/decode-float.circom:5-9).
"""

from __future__ import annotations

MANTISSA_BITS = 35
EXP_BITS = 5
MANTISSA_MAX = (1 << MANTISSA_BITS) - 1


def float2fix(fl: int) -> int:
    m = fl & MANTISSA_MAX
    e = fl >> MANTISSA_BITS
    return m * 10 ** e


def fix2float(fix: int) -> int:
    """Exact conversion; raises if `fix` is not representable."""
    if fix == 0:
        return 0
    m, e = fix, 0
    while m > MANTISSA_MAX:
        if m % 10 != 0:
            raise ValueError(f"not enough precision to encode {fix} as float40")
        m //= 10
        e += 1
    if e >= (1 << EXP_BITS):
        raise ValueError(f"exponent overflow encoding {fix}")
    return (e << MANTISSA_BITS) | m


def floor_fix2float(fix: int) -> int:
    """Largest representable value <= fix."""
    if fix == 0:
        return 0
    m, e = fix, 0
    while m > MANTISSA_MAX:
        m //= 10
        e += 1
    if e >= (1 << EXP_BITS):
        raise ValueError(f"exponent overflow encoding {fix}")
    return (e << MANTISSA_BITS) | m


def round_fix(fix: int) -> int:
    """Nearest representable fix value (half rounds up); returns the FIX
    (integer amount), not the float encoding — matching commonjs
    float40.round usage `amount: float40.round(x)`."""
    if fix == 0:
        return 0
    m, e = fix, 0
    while m > MANTISSA_MAX:
        r = m % 10
        m //= 10
        if r >= 5:
            m += 1
        e += 1
    return m * 10 ** e
