"""The carry-over between the packages: the port packs a builder input
exactly as `packed_from_jax` converts the JAX package's packing, and the
port's constant tables, built from the shared host code alone, equal the
JAX package's."""

import numpy as np
import pytest
import torch

from circuits_tpu.engine import witness as jwit
from circuits_tpu.ops import babyjubjub as jbjj
from circuits_tpu.ops import poseidon as jpos
from circuits_tpu.ops import sha256 as jsha
from circuits_tpu_torch import convert
from circuits_tpu_torch.engine import witness as twit

from torch_compare import SUITE_CONFIG, suite_batches


@pytest.fixture(scope="module")
def batches():
    return suite_batches()


@pytest.mark.parametrize("which", ["deposit", "l2"])
def test_pack_equals_packed_from_jax(batches, which):
    inp = batches[which].get_input()
    jax_packed = jwit.pack_rollup_inputs(inp, *SUITE_CONFIG)
    want = convert.packed_from_jax({k: np.asarray(v)
                                    for k, v in jax_packed.items()})
    got = twit.pack_rollup_inputs(inp, *SUITE_CONFIG)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.int64, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_comb_table_equals_jax():
    assert np.array_equal(convert.comb_table(),
                          jbjj._base8_window_table())


@pytest.mark.parametrize("t", convert.POSEIDON_WIDTHS)
def test_poseidon_tables_equal_jax(t):
    c, m = convert.poseidon_tables(t)
    jc, _, jm = jpos._device_constants(t)
    assert np.array_equal(c.transpose(0, 2, 1), jc[..., 0])
    assert np.array_equal(m.transpose(2, 0, 1), jm[..., 0])


def test_kernel_words_are_the_tables():
    words = convert.poseidon_kernel_words()
    start = 0
    for t in convert.POSEIDON_WIDTHS:
        c, m = convert.poseidon_tables(t)
        block = np.concatenate([c.reshape(-1, 16), m.reshape(-1, 16)])
        got = words[start:start + len(block)]
        assert np.array_equal(got, convert.limbs_to_words(block)), t
        start += len(block)
    assert start == len(words)


def test_sha256_tables_equal_jax():
    k, h0 = convert.sha256_tables()
    assert np.array_equal(k, jsha._K)
    assert np.array_equal(h0, jsha._H0)
