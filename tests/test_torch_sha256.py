"""The port's SHA-256 (K4's plain version on the CPU) against the JAX
package -- its `sha256_bits` and its Pallas rounds kernel in interpret
mode -- and hashlib, at 1, 2 and 3 blocks. Exact."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuits_tpu.ops import sha256 as jsha
from circuits_tpu.ops.pallas_sha256 import sha256_chain as pallas_chain
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


def test_digest_to_field_reduces_mod_p():
    bits = np.ones((256, 1), dtype=np.uint32)
    assert_same(sha256.digest_to_field(to_torch(bits)),
                jsha.digest_to_field(jnp.asarray(bits)))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        sha256.sha256_chain(torch.zeros((16, 1), dtype=torch.int64,
                                        device="meta"), 1)
