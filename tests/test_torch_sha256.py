"""The port's SHA-256 (K4's plain version on the CPU) against the JAX
package -- its `sha256_bits` and its Pallas rounds kernel in interpret
mode -- and hashlib, at 1, 2 and 3 blocks; and kernel K4's schedule (K + W
block by block, the ring of stages, the pre-added round) mirrored in Python
integers against hashlib. Exact."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuits_tpu.ops import sha256 as jsha
from circuits_tpu.ops.pallas_sha256 import sha256_chain as pallas_chain
from circuits_tpu_torch import convert
from circuits_tpu_torch.ops import sha256

from torch_compare import assert_same, to_torch


def _hashlib_bits(bits):
    msg = bytes(int("".join(map(str, bits[i:i + 8])), 2)
                for i in range(0, len(bits), 8))
    d = hashlib.sha256(msg).digest()
    return [(byte >> (7 - j)) & 1 for byte in d for j in range(8)]


@pytest.mark.parametrize("nbits", [8, 512, 1000])  # 1, 2 and 3 blocks
def test_sha256_bits_matches_jax_and_hashlib(nbits):
    rng = np.random.default_rng(nbits)
    bits = rng.integers(0, 2, size=(nbits, 2)).astype(np.uint32)
    got = sha256.sha256_bits(to_torch(bits))
    assert_same(got, jsha.jsha256_bits(bits))
    for b in range(2):
        assert got[:, b].tolist() == _hashlib_bits(bits[:, b].tolist())


@pytest.mark.parametrize("nbits", [8, 512, 1000])
def test_chain_matches_pallas_interpret(nbits):
    rng = np.random.default_rng(7 + nbits)
    nblocks = (nbits + 65 + 511) // 512
    words = rng.integers(0, 2**32, size=(nblocks * 16, 1), dtype=np.uint64)
    words = words.astype(np.uint32)
    want = pallas_chain(jnp.asarray(words), nblocks, interpret=True)
    assert_same(sha256.sha256_chain(to_torch(words), nblocks), want)


_M32 = 0xFFFFFFFF
# csrc/sha256.cu: message blocks a stage, stages of the ring
STAGE_BLOCKS, STAGES = 32, 3


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def _kw_of_block(w16, K):
    """The producer thread's work: one message block's 16 words, expanded
    in a 16-word ring, to its 64 sums K + W. Needs no other block."""
    w, out = list(w16), []
    for i in range(64):
        if i >= 16:
            w15, w2 = w[(i - 15) & 15], w[(i - 2) & 15]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            w[i & 15] = (w[i & 15] + s0 + w[(i - 7) & 15] + s1) & _M32
        out.append((K[i] + w[i & 15]) & _M32)
    return out


def _pre_added_round(s, kw):
    """The kernel's round: h + (K + W) and d + that are formed apart from
    the newest e and a."""
    a, b, c, d, e, f, g, h = s
    hx = (h + kw) & _M32
    dhx = (d + hx) & _M32
    s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
    ch = (e & f) ^ (~e & g & _M32)
    s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
    maj = (a & b) ^ (a & c) ^ (b & c)
    t1 = (hx + s1 + ch) & _M32
    return ((t1 + s0 + maj) & _M32, a, b, c, (dhx + s1 + ch) & _M32, e, f, g)


def _narrow_route_mirror(words, nblocks, K, h0):
    """The narrow route of csrc/sha256.cu in Python: producer warps fill
    the ring stage by stage, the consumer reads the next block's K + W while
    it runs the current block's rounds, and stages change hands through
    barriers with a phase parity. Every wait is checked against the
    barrier's phase, so a wrong slot, stage or parity fails here."""
    nstages = -(-nblocks // STAGE_BLOCKS)
    ring = [[None] * STAGE_BLOCKS for _ in range(STAGES)]
    full = [0] * STAGES   # completed phases of each barrier
    empty = [0] * STAGES
    filled = [0] * STAGES  # how often each slot's producer has filled it

    def produce(slot):
        """Fill the slot's next stage if its `empty` wait would pass."""
        st = slot + STAGES * filled[slot]
        if st >= nstages:
            return False
        use = filled[slot]
        if use > 0 and not empty[slot] > (use - 1):
            return False  # the wait on parity (use - 1) & 1 still blocks
        for lane in range(STAGE_BLOCKS):
            blk = st * STAGE_BLOCKS + lane
            if blk < nblocks:
                ring[slot][lane] = (blk, _kw_of_block(
                    words[16 * blk:16 * blk + 16], K))
        filled[slot] += 1
        full[slot] += 1
        return True

    def wait_full(slot, parity):
        while not (full[slot] % 2 != parity and full[slot] > 0):
            assert any(produce(s) for s in range(STAGES)), "deadlock"

    h = list(h0)
    wait_full(0, 0)
    held = ring[0][0]
    for blk in range(nblocks):
        nxt = min(blk + 1, nblocks - 1)
        nst, nslot = nxt // STAGE_BLOCKS, (nxt // STAGE_BLOCKS) % STAGES
        if nxt != blk and nxt % STAGE_BLOCKS == 0:
            wait_full(nslot, (nst // STAGES) & 1)
        assert held[0] == blk
        s = tuple(h)
        for i in range(64):
            s = _pre_added_round(s, held[1][i])
        held = ring[nslot][nxt % STAGE_BLOCKS]
        h = [(x + y) & _M32 for x, y in zip(h, s)]
        if blk % STAGE_BLOCKS == STAGE_BLOCKS - 1:
            empty[(blk // STAGE_BLOCKS) % STAGES] += 1
            for slot in range(STAGES):  # producers that were waiting
                produce(slot)
    return h


@pytest.mark.parametrize("nblocks", [1, 2, 3, 97, 822])
def test_kernel_schedule_ring_and_round_mirror(nblocks):
    """K + W block by block, the ring's hand-over and the pre-added round,
    as kernel K4 computes them, against hashlib; 97 blocks end inside a
    stage and 822 is the rollup HashInputs preimage at 2048 transactions."""
    K, h0 = ([int(v) for v in t] for t in convert.sha256_tables())
    rng = np.random.default_rng(nblocks)
    msg = rng.integers(0, 256, 64 * nblocks - 9, dtype=np.uint8).tobytes()
    padded = msg + b"\x80" + (8 * len(msg)).to_bytes(8, "big")
    assert len(padded) == 64 * nblocks
    words = [int.from_bytes(padded[i:i + 4], "big")
             for i in range(0, len(padded), 4)]
    got = _narrow_route_mirror(words, nblocks, K, h0)
    digest = b"".join(v.to_bytes(4, "big") for v in got)
    assert digest == hashlib.sha256(msg).digest()
    if nblocks <= 97:  # and the plain version on the same words
        plain = sha256.sha256_chain(
            torch.tensor(words, dtype=torch.int64)[:, None], nblocks)
        assert plain[:, 0].tolist() == got


def test_digest_to_field_reduces_mod_p():
    bits = np.ones((256, 1), dtype=np.uint32)
    assert_same(sha256.digest_to_field(to_torch(bits)),
                jsha.digest_to_field(jnp.asarray(bits)))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        sha256.sha256_chain(torch.zeros((16, 1), dtype=torch.int64,
                                        device="meta"), 1)
