"""Batched SHA-256 over bit arrays (circomlib Sha256(nBits) semantics).

Port of `circuits_tpu/ops/sha256.py`: the message is padded and packed
into 32-bit words (held in int64), and the compression chain runs in
`sha256_chain`, the wrapper of kernel K4 (csrc/sha256.cu), whose plain
version is `sha256_chain_plain`.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from .. import kernels
from ..convert import sha256_tables
from ..field import fr

_M32 = 0xFFFFFFFF


@lru_cache(maxsize=None)
def _tables(device: torch.device):
    k, h0 = sha256_tables()
    return ([int(v) for v in k],
            torch.tensor(h0.astype("int64"), device=device))


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def sha256_chain_plain(words: torch.Tensor, nblocks: int) -> torch.Tensor:
    """words (nblocks * 16, B) padded message words -> (8, B) final state,
    plain PyTorch (int64 lanes, every sum masked to 32 bits)."""
    K, h0 = _tables(words.device)
    b = words.shape[1]
    h = [h0[i].expand(b) for i in range(8)]
    warr = words.reshape(nblocks, 16, b)
    for blk in range(nblocks):
        w = [warr[blk, i] for i in range(16)]
        for i in range(16, 64):
            s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
            s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
            w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
        a, bb, c, d, e, f, g, hh = h
        for i in range(64):
            s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ ((e ^ _M32) & g)
            t1 = hh + s1 + ch + K[i] + w[i]
            s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            t2 = s0 + ((a & bb) ^ (a & c) ^ (bb & c))
            hh, g, f, e, d, c, bb, a = (g, f, e, (d + t1) & _M32, c, bb, a,
                                        (t1 + t2) & _M32)
        h = [(x + y) & _M32 for x, y in zip(h, (a, bb, c, d, e, f, g, hh))]
    return torch.stack(h)


def sha256_chain(words: torch.Tensor, nblocks: int) -> torch.Tensor:
    """Wrapper of kernel K4; arguments as `sha256_chain_plain`."""
    dev = words.device
    if dev.type == "cpu":
        return sha256_chain_plain(words, nblocks)
    if dev.type != "cuda":
        raise ValueError(f"sha256_chain: unsupported device {dev}")
    b = words.shape[1]
    kernels.require(words, "words", torch.int64, (nblocks * 16, b), dev)
    so = kernels.prepare(dev)
    out = torch.empty((8, b), dtype=torch.int64, device=dev)
    kernels.launch("sha256_chain", so.ctpu_sha256_chain(
        kernels.ptr(words), kernels.ptr(out), nblocks, b,
        kernels.stream_ptr(dev)))
    return out


def sha256_bits(bits: torch.Tensor) -> torch.Tensor:
    """bits (nBits, *batch) 0/1, MSB-first message bits -> digest bits
    (256, *batch) MSB-first (= circomlib Sha256 out[])."""
    nbits = bits.shape[0]
    bshape = tuple(bits.shape[1:])
    nblocks = (nbits + 65 + 511) // 512
    total = nblocks * 512
    pad = [0] * (total - nbits)
    pad[0] = 1
    for i in range(64):
        pad[-64 + i] = (nbits >> (63 - i)) & 1
    pad_t = torch.tensor(pad, dtype=torch.int64, device=bits.device)
    allbits = torch.cat([bits.long().reshape(nbits, -1),
                         pad_t[:, None].expand(-1, math.prod(bshape))])
    weights = (1 << torch.arange(31, -1, -1, device=bits.device))[None, :,
                                                                   None]
    words = (allbits.reshape(total // 32, 32, -1) * weights).sum(dim=1) & _M32
    state = sha256_chain(words.contiguous(), nblocks)  # (8, Bflat)
    shifts = torch.arange(31, -1, -1, device=bits.device)[None, :, None]
    out = (state[:, None] >> shifts) & 1
    return out.reshape((256,) + bshape)


def digest_to_field(digest_bits: torch.Tensor) -> torch.Tensor:
    """256 MSB-first digest bits -> field element (the 256-bit big-endian
    integer reduced mod p), as hash-inputs.circom:179-184."""
    return fr.from_bits_le(torch.flip(digest_bits, dims=[0]))
