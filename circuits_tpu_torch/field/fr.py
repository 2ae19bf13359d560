"""BN254 Fr arithmetic on batched limb tensors (plain PyTorch).

Layout and dtype:
  * A field batch is an ``int64`` tensor of shape ``(16, *batch)``: 16
    little-endian limbs of 16 bits each, limb axis leading, lane axis
    last -- the JAX package's layout (`circuits_tpu/field/fr.py`), with
    ``int64`` as the one interchange dtype of the port. CPU PyTorch has no
    arithmetic on ``uint32``, and a product of two 16-bit limbs needs 32
    unsigned bits, so the limbs live in ``int64`` lanes; numpy ``uint32``
    appears only where tests compare with JAX.
  * Bit arrays are ``int64`` 0/1 tensors ``(nbits, *batch)``; predicates
    are ``bool`` tensors ``(*batch)``.
  * Every function works on the device of its inputs.

Carries and borrows are resolved without a Python loop over limbs: a few
vectorised carry-save passes bring every column below 2^17, then one
carry-lookahead step (`_lookahead`, a cumulative max over the limb axis)
finds the carry into each limb. The Montgomery product (R = 2^256) is a
schoolbook over the limb axis summed along anti-diagonals
(`_diag_sum`, the JAX package's `_DIAG_IDX` idea) followed by the 16
sequential CIOS reduction steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import scalar
P, N_LIMBS, LIMB_BITS = scalar.P, scalar.N_LIMBS, scalar.LIMB_BITS
LIMB_MASK, N0, R, R2 = scalar.LIMB_MASK, scalar.N0, scalar.R, scalar.R2

MASK = LIMB_MASK
_I64 = torch.int64
_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host <-> tensor conversion
# ---------------------------------------------------------------------------


def pack_np(values) -> np.ndarray:
    """Python ints (nested lists / 1-D) -> uint32 limb array (16, *shape)."""
    arr = np.asarray(values, dtype=object)
    flat = arr.reshape(-1)
    buf = b"".join((int(v) % P).to_bytes(32, "little") for v in flat)
    limbs = np.frombuffer(buf, dtype="<u2").reshape(len(flat), N_LIMBS)
    return np.ascontiguousarray(limbs.T).astype(np.uint32).reshape(
        (N_LIMBS,) + arr.shape)


def pack(values, device=None) -> torch.Tensor:
    return torch.from_numpy(pack_np(values).astype(np.int64)).to(device)


def to_numpy(x) -> np.ndarray:
    """Tensor (any device) or array -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def unpack_np(arr) -> np.ndarray:
    """Limb array (16, *shape) -> object ndarray of Python ints."""
    a = to_numpy(arr)
    assert a.shape[0] == N_LIMBS
    flat = a.reshape(N_LIMBS, -1).T.astype("<u2")
    raw = np.ascontiguousarray(flat).tobytes()
    out = np.empty((flat.shape[0],), dtype=object)
    for i in range(flat.shape[0]):
        out[i] = int.from_bytes(raw[32 * i:32 * i + 32], "little")
    return out.reshape(a.shape[1:])


def unpack_int(arr) -> int:
    """Single element (16,) or (16, 1, ...) -> Python int."""
    res = unpack_np(to_numpy(arr).reshape(N_LIMBS, -1))
    assert res.size == 1
    return int(res.reshape(-1)[0])


def _limbs_of(x: int, n: int = N_LIMBS) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & MASK for i in range(n)]


def _col(limbs, ndim: int, device) -> torch.Tensor:
    """Limb list -> (n, 1, ..., 1) tensor broadcasting over `ndim - 1`
    batch axes."""
    t = torch.tensor(limbs, dtype=_I64, device=device)
    return t.reshape((len(limbs),) + (1,) * (ndim - 1))


def const(x: int, batch_shape=(), device=None) -> torch.Tensor:
    """Broadcastable constant with shape (16, *[1]*len(batch_shape))."""
    return _col(scalar.to_limbs(x), 1 + len(batch_shape), device)


def zeros(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((N_LIMBS,) + tuple(batch_shape), dtype=_I64,
                       device=device)


# ---------------------------------------------------------------------------
# Carry handling
# ---------------------------------------------------------------------------


def _lookahead(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Carry (or borrow) into each position of a limb chain.

    gen/prop: (n, *batch) bool -- the limb generates a carry / passes an
    incoming one on. Returns (n + 1, *batch) bool: row k is the carry into
    limb k, row n the carry out of the top. The carry out of limb k is
    `gen` at the last limb j <= k that does not propagate."""
    n = gen.shape[0]
    idx = torch.arange(n, device=gen.device).reshape(
        (n,) + (1,) * (gen.dim() - 1))
    last = torch.cummax(torch.where(prop, -1, idx), dim=0).values
    out = torch.gather(gen, 0, last.clamp(min=0)) & (last >= 0)
    return torch.cat([torch.zeros_like(out[:1]), out], dim=0)


def _norm(cols: torch.Tensor, bits: int) -> torch.Tensor:
    """Exact carry propagation: (n, *batch) columns, each in [0, 2^bits),
    -> (n + 1, *batch) limbs < 2^16 of the same value."""
    c = torch.cat([cols, torch.zeros_like(cols[:1])], dim=0)
    passes = 0 if bits <= 17 else -(-(bits - LIMB_BITS) // LIMB_BITS)
    for _ in range(passes):
        hi = c >> LIMB_BITS
        c = c & MASK
        c[1:] += hi[:-1]
    carry = _lookahead(c > MASK, c == MASK)
    return (c + carry[:-1].to(_I64)) & MASK


def _sub_raw(a: torch.Tensor, m: torch.Tensor):
    """a - m over normalised limbs -> (limbs mod 2^(16n), borrow out)."""
    d = a - m
    borrow = _lookahead(d < 0, d == 0)
    return (d - borrow[:-1].to(_I64)) & MASK, borrow[-1]


def _sub_if_ge(limbs: torch.Tensor, mod: int) -> torch.Tensor:
    """limbs (n, *batch) normalised; subtract the integer `mod` where
    limbs >= mod."""
    m = _col(_limbs_of(mod, limbs.shape[0]), limbs.dim(), limbs.device)
    diff, borrow = _sub_raw(limbs, m)
    return torch.where(borrow[None], limbs, diff)


def _reduce_below(limbs: torch.Tensor, k: int) -> torch.Tensor:
    """Value < k*p -> canonical, by conditional subtraction of p*2^j,
    largest first (the JAX package's `sum_list` reduction)."""
    j = 0
    while (1 << j) < k:
        j += 1
    for shift in range(j - 1, -1, -1):
        limbs = _sub_if_ge(limbs, P << shift)
    return limbs[:N_LIMBS]


_P_LIMBS = _limbs_of(P)


def _p_col(ref: torch.Tensor) -> torch.Tensor:
    return _col(_P_LIMBS, ref.dim(), ref.device)


# ---------------------------------------------------------------------------
# Add / sub / neg
# ---------------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p; inputs canonical."""
    return _sub_if_ge(_norm(a + b, 17), P)[:N_LIMBS]


def sum_list(elems: list) -> torch.Tensor:
    """Sum of up to ~2^15 canonical elements, elementwise over the batch."""
    k = len(elems)
    assert k >= 1
    if k == 1:
        return elems[0]
    cols = elems[0]
    for e in elems[1:]:
        cols = cols + e
    return _reduce_below(_norm(cols, 16 + k.bit_length()), k)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p; inputs canonical."""
    a, b = torch.broadcast_tensors(a, b)
    diff, borrow = _sub_raw(a, b)
    wrapped = _norm(diff + _p_col(diff), 17)[:N_LIMBS]
    return torch.where(borrow[None], wrapped, diff)


def neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p; input canonical."""
    return sub(torch.zeros_like(a), a)


# ---------------------------------------------------------------------------
# Montgomery multiplication
# ---------------------------------------------------------------------------


def _diag_sum(prod: torch.Tensor) -> torch.Tensor:
    """prod (16, 16, *batch) with prod[i, j] at weight 2^(16(i+j)) ->
    (33, *batch) columns. Row i padded to width 34 and flattened puts
    (i, j) at 34 i + j, which re-reads as row i, column i + j of a
    (16, 33) array -- the anti-diagonals become columns."""
    bshape = prod.shape[2:]
    ncols = 2 * N_LIMBS + 1
    pad = [0, 0] * len(bshape) + [0, ncols + 1 - N_LIMBS]
    rows = torch.nn.functional.pad(prod, pad)  # (16, 34, *batch)
    flat = rows.reshape((N_LIMBS * (ncols + 1),) + bshape)
    return flat[:N_LIMBS * ncols].reshape((N_LIMBS, ncols) + bshape).sum(0)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^{-1} mod p. Inputs canonical (< p), output canonical.
    Broadcasts over the batch axes."""
    bshape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.expand((N_LIMBS,) + bshape)
    b = b.expand((N_LIMBS,) + bshape)
    cols = _diag_sum(a.unsqueeze(1) * b.unsqueeze(0))  # each < 2^36
    pl = _col(_P_LIMBS, 1 + len(bshape), a.device)
    for i in range(N_LIMBS):
        m = (cols[i] * N0) & MASK
        cols[i:i + N_LIMBS].addcmul_(pl, m.unsqueeze(0))
        cols[i + 1] += cols[i] >> LIMB_BITS
    # each column < 2^38; the value is < 2p
    return _sub_if_ge(_norm(cols[N_LIMBS:], 38), P)[:N_LIMBS]


def to_mont(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, const(R2, a.shape[1:], a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, const(1, a.shape[1:], a.device))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical-domain modular multiply (2 Montgomery multiplies)."""
    return mont_mul(mont_mul(a, b), const(R2, a.shape[1:], a.device))


def mont_const(x: int, ref: torch.Tensor) -> torch.Tensor:
    """Constant x in Montgomery form, broadcastable against `ref`."""
    return const((x * R) % P, ref.shape[1:], ref.device)


# ---------------------------------------------------------------------------
# Predicates / selection
# ---------------------------------------------------------------------------


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(batch,) bool."""
    return (a == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """cond ? a : b ; cond has batch shape (bool or 0/1)."""
    return torch.where(cond.bool().unsqueeze(0), a, b)


# ---------------------------------------------------------------------------
# Bit decomposition (canonical inputs)
# ---------------------------------------------------------------------------


def _bit_offs(ndim: int, device) -> torch.Tensor:
    return torch.arange(LIMB_BITS, dtype=_I64, device=device).reshape(
        (1, LIMB_BITS) + (1,) * ndim)


def bits_le(a: torch.Tensor, nbits: int) -> torch.Tensor:
    """Canonical input -> (nbits, *batch) int64 0/1, little-endian."""
    offs = _bit_offs(a.dim() - 1, a.device)
    allbits = (a.unsqueeze(1) >> offs) & 1  # (16, 16, *batch)
    return allbits.reshape((N_LIMBS * LIMB_BITS,) + a.shape[1:])[:nbits]


def from_bits_le(bits: torch.Tensor) -> torch.Tensor:
    """(nbits, *batch) bits -> canonical field element, value reduced mod p
    (nbits <= 256; circom Bits2Num semantics). Like the JAX package, the
    weighted sums are taken in 32-bit arithmetic."""
    nbits = bits.shape[0]
    assert nbits <= 256
    bshape = bits.shape[1:]
    bits = bits.to(_I64) & _MASK32
    if nbits < 256:
        bits = torch.cat([bits, bits.new_zeros((256 - nbits,) + bshape)])
    grouped = bits.reshape((N_LIMBS, LIMB_BITS) + bshape)
    cols = ((grouped << _bit_offs(len(bshape), bits.device)) & _MASK32
            ).sum(dim=1) & _MASK32
    limbs = _norm(cols, 32)
    # value < 2^256 < 8p: conditional subtraction of 4p, 2p, p
    for shift in ([2, 1, 0] if nbits > 254 else [0]):
        limbs = _sub_if_ge(limbs, P << shift)
    return limbs[:N_LIMBS]


def shift_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * 2^k for small values: caller guarantees a * 2^k < p. No
    reduction."""
    whole, rem = divmod(k, LIMB_BITS)
    out = torch.zeros_like(a)
    if rem == 0:
        out[whole:] = a[:N_LIMBS - whole]
        return out
    out[whole:] |= (a[:N_LIMBS - whole] << rem) & MASK
    out[whole + 1:] |= a[:N_LIMBS - whole - 1] >> (LIMB_BITS - rem)
    return out


def low_u32(a: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of a canonical element, (batch,) int64."""
    return a[0] | (a[1] << LIMB_BITS)


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """(batch,) integers (taken mod 2^32) -> field element."""
    x = x.to(_I64) & _MASK32
    out = torch.zeros((N_LIMBS,) + x.shape, dtype=_I64, device=x.device)
    out[0] = x & MASK
    out[1] = x >> LIMB_BITS
    return out


def from_bool(x: torch.Tensor) -> torch.Tensor:
    return from_u32(x.to(_I64))


# ---------------------------------------------------------------------------
# Exponentiation / inversion / sqrt
# ---------------------------------------------------------------------------


def _pow_const_mont(a_mont: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a fixed exponent; Montgomery in/out. LSB-first
    square-and-multiply; the exponent is a host constant, so the
    multiplies happen only at its set bits."""
    acc = None
    base = a_mont
    nbits = e.bit_length()
    for i in range(nbits):
        if (e >> i) & 1:
            acc = base if acc is None else mont_mul(acc, base)
        if i + 1 < nbits:
            base = mont_mul(base, base)
    if acc is None:
        return mont_const(1, a_mont).expand(a_mont.shape).clone()
    return acc


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """Canonical in/out fixed-exponent power."""
    return from_mont(_pow_const_mont(to_mont(a), e))


def inv(a: torch.Tensor) -> torch.Tensor:
    """Batched modular inverse (0 -> 0, matching circomlib's IsZero hint)."""
    z = is_zero(a)
    safe = select(z, const(1, a.shape[1:], a.device), a)
    r = from_mont(_pow_const_mont(to_mont(safe), P - 2))
    return select(z, zeros(a.shape[1:], a.device), r)


def sqrt(a: torch.Tensor):
    """Batched Tonelli-Shanks square root, the JAX package's constant-
    structure schedule. Returns (root, ok): root^2 == a where ok; root is
    the minimal root min(r, p - r), and 0 where `a` is a non-residue."""
    K = scalar.TWO_ADICITY
    Q = scalar.Q_ODD
    z = is_zero(a)
    safe = select(z, const(1, a.shape[1:], a.device), a)
    am = to_mont(safe)
    t = _pow_const_mont(am, Q)
    r = _pow_const_mont(am, (Q + 1) // 2)
    c = mont_const(scalar.ROOT_OF_UNITY, am).expand(am.shape)
    one_m = mont_const(1, am)
    for i in range(K, 1, -1):
        b = t
        for _ in range(i - 2):
            b = mont_mul(b, b)
        b_is_one = eq(b, one_m)
        r = select(b_is_one, r, mont_mul(r, c))
        c = mont_mul(c, c)
        t = select(b_is_one, t, mont_mul(t, c))
    root = from_mont(r)
    ok = eq(mul(root, root), safe) & ~z
    root = select(z | ~ok, zeros(a.shape[1:], a.device), root)
    other = neg(root)
    root = select(gt(root, other), other, root)
    return root, ok | z


def gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a > b as integers (canonical); (batch,) bool. Decided at the most
    significant differing limb."""
    a, b = torch.broadcast_tensors(a, b)
    d = a - b
    idx = torch.arange(N_LIMBS, device=a.device).reshape(
        (N_LIMBS,) + (1,) * (a.dim() - 1))
    top = torch.where(d != 0, idx, -1).max(dim=0).values
    picked = torch.gather(d, 0, top.clamp(min=0).unsqueeze(0))[0]
    return (top >= 0) & (picked > 0)


def geq_const(a: torch.Tensor, x: int) -> torch.Tensor:
    return ~gt(const(x, a.shape[1:], a.device), a)
