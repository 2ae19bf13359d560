"""Host-side primitive hashes/curves needed for exact parity with the
reference's JS dependency stack:

  * BLAKE-512 (original BLAKE) — circomlib's `eddsa.js` derives babyjubjub
    keys via the npm `blake-hash` package (BLAKE-512), used by
    HermezAccount key derivation.
  * Keccak-256 — ethereum address derivation for HermezAccount.
  * secp256k1 — ethereum public keys (HermezAccount(i) uses the i-th
    ethereum private key; e.g. test/lib/hash-state.test.js:36 hard-codes
    the address of private key 1).

Pure Python; all host-side (never on the device compute path).
"""

from __future__ import annotations

M64 = (1 << 64) - 1

# ---------------------------------------------------------------------------
# BLAKE-512 (the SHA-3 finalist, not BLAKE2)
# ---------------------------------------------------------------------------

_BLAKE_U = [
    0x243F6A8885A308D3, 0x13198A2E03707344, 0xA4093822299F31D0,
    0x082EFA98EC4E6C89, 0x452821E638D01377, 0xBE5466CF34E90C6C,
    0xC0AC29B7C97C50DD, 0x3F84D5B5B5470917, 0x9216D5D98979FB1B,
    0xD1310BA698DFB5AC, 0x2FFD72DBD01ADFB7, 0xB8E1AFED6A267E96,
    0xBA7C9045F12C7F99, 0x24A19947B3916CF7, 0x0801F2E2858EFC16,
    0x636920D871574E69,
]

_BLAKE_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


def _rotr64(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & M64


def _blake512_compress(h: list[int], block: bytes, t: int) -> list[int]:
    m = [int.from_bytes(block[8 * i:8 * i + 8], "big") for i in range(16)]
    v = h[:] + [
        _BLAKE_U[0], _BLAKE_U[1], _BLAKE_U[2], _BLAKE_U[3],
        (t & M64) ^ _BLAKE_U[4], (t & M64) ^ _BLAKE_U[5],
        ((t >> 64) & M64) ^ _BLAKE_U[6], ((t >> 64) & M64) ^ _BLAKE_U[7],
    ]

    def g(r, i, a, b, c, d):
        s = _SIGMA[r % 10]
        v[a] = (v[a] + v[b] + (m[s[2 * i]] ^ _BLAKE_U[s[2 * i + 1]])) & M64
        v[d] = _rotr64(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & M64
        v[b] = _rotr64(v[b] ^ v[c], 25)
        v[a] = (v[a] + v[b] + (m[s[2 * i + 1]] ^ _BLAKE_U[s[2 * i]])) & M64
        v[d] = _rotr64(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & M64
        v[b] = _rotr64(v[b] ^ v[c], 11)

    for r in range(16):
        g(r, 0, 0, 4, 8, 12)
        g(r, 1, 1, 5, 9, 13)
        g(r, 2, 2, 6, 10, 14)
        g(r, 3, 3, 7, 11, 15)
        g(r, 4, 0, 5, 10, 15)
        g(r, 5, 1, 6, 11, 12)
        g(r, 6, 2, 7, 8, 13)
        g(r, 7, 3, 4, 9, 14)
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake512(data: bytes) -> bytes:
    h = _BLAKE_IV[:]
    bitlen = len(data) * 8
    # padding: bit 1, zeros, bit 1 (so data ends at 111 mod 128 bytes),
    # then 128-bit big-endian bit length; the two 1-bits share a byte
    # (0x81) when the message length is exactly 111 mod 128.
    msg = bytearray(data)
    msg.append(0x80)
    if len(msg) % 128 == 112:
        msg[-1] = 0x81
    else:
        while len(msg) % 128 != 111:
            msg.append(0x00)
        msg.append(0x01)
    msg += (bitlen).to_bytes(16, "big")
    assert len(msg) % 128 == 0
    remaining = bitlen
    for off in range(0, len(msg), 128):
        block = bytes(msg[off:off + 128])
        msg_bits_here = min(remaining, 1024)
        remaining -= msg_bits_here
        # counter = message bits processed up to and including this block;
        # a block with no message bits uses t = 0 (BLAKE spec quirk)
        t = 0 if msg_bits_here == 0 else (bitlen - remaining)
        h = _blake512_compress(h, block, t)
    return b"".join(w.to_bytes(8, "big") for w in h)


# ---------------------------------------------------------------------------
# Keccak-256 (original Keccak padding 0x01/0x80, as used by ethereum)
# ---------------------------------------------------------------------------

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_KECCAK_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl64(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & M64


def _keccak_f(a):
    for rnd in range(24):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl64(a[x][y], _KECCAK_ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & M64)
        # iota
        a[0][0] ^= _KECCAK_RC[rnd]
    return a


def keccak256(data: bytes) -> bytes:
    rate = 136
    msg = bytearray(data)
    # pad10*1 with multi-rate padding byte 0x01 (keccak, not sha3's 0x06)
    padlen = rate - (len(msg) % rate)
    msg += b"\x01" + b"\x00" * (padlen - 2) + b"\x80" if padlen >= 2 else b"\x81"
    a = [[0] * 5 for _ in range(5)]
    for off in range(0, len(msg), rate):
        block = msg[off:off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i:8 * i + 8], "little")
            x, y = i % 5, i // 5
            a[x][y] ^= lane
        a = _keccak_f(a)
    out = b""
    i = 0
    while len(out) < 32:
        x, y = i % 5, i // 5
        out += a[x][y].to_bytes(8, "little")
        i += 1
    return out[:32]


# ---------------------------------------------------------------------------
# secp256k1 (ethereum address derivation only)
# ---------------------------------------------------------------------------

_SECP_P = 2**256 - 2**32 - 977
_SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_SECP_G = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)


def _secp_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % _SECP_P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1) * pow(2 * y1, -1, _SECP_P) % _SECP_P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, _SECP_P) % _SECP_P
    x3 = (lam * lam - x1 - x2) % _SECP_P
    y3 = (lam * (x1 - x3) - y1) % _SECP_P
    return (x3, y3)


def _secp_mul(k: int, pt):
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = _secp_add(acc, add)
        add = _secp_add(add, add)
        k >>= 1
    return acc


def eth_address(priv: int) -> str:
    """0x-prefixed lowercase ethereum address of a private key."""
    pub = _secp_mul(priv % _SECP_N, _SECP_G)
    raw = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
    return "0x" + keccak256(raw)[12:].hex()
