"""BLAKE-512 (original BLAKE), which circomlib's `eddsa.js` derives
BabyJubJub keys with (the npm `blake-hash` package). Pure Python, on the
host."""

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
