"""The CUDA kernels K1-K4 against their plain PyTorch versions on the card,
and the suite's batches through `RollupEngine` on `cuda`. These tests need a
CUDA device and skip without one. They import no JAX, so they also run on a
machine that has none:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m gpu tests/test_torch_cuda.py
"""

import hashlib

import numpy as np
import pytest
import torch

from circuits_tpu_torch import kernels
from circuits_tpu_torch.engine.witness import RollupEngine
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.host import babyjub, scalar
from circuits_tpu_torch.ops import babyjubjub, poseidon, sha256, smt

from torch_compare import (SUITE_CONFIG, assert_same, oracle_outputs,
                           suite_batches)

pytestmark = pytest.mark.gpu

LANES = 300  # not a multiple of the kernels' block sizes


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _field(rng, shape):
    """Canonical field elements (16, *shape) from numpy's generator."""
    vals = rng.integers(0, 2**63, size=shape + (4,), dtype=np.uint64)
    ints = [sum(int(w) << (64 * i) for i, w in enumerate(row)) % scalar.P
            for row in vals.reshape(-1, 4)]
    return fr.pack(np.array(ints, dtype=object).reshape(shape).tolist())


@pytest.mark.parametrize("t", [3, 4, 5, 6, 7])
def test_poseidon_kernel_matches_plain(cuda, t):
    state = _field(np.random.default_rng(t), (t, LANES)).to(cuda)
    assert_same(poseidon.permute_mont(state),
                poseidon.permute_mont_plain(state))


def test_smt_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    n = 9
    sib = _field(rng, (n, LANES)).permute(1, 0, 2).contiguous()
    sib[:, :, ::3] = 0  # empty subtrees below some lanes
    bits = torch.from_numpy(rng.integers(0, 2, (n, LANES)))
    masks = torch.from_numpy(rng.integers(0, 2, (n, 5, LANES)))
    leaves = [_field(rng, (LANES,)) for _ in range(3)]
    args = [x.to(cuda).contiguous() for x in (sib, bits, masks, *leaves)]
    assert_same(smt.processor_chain(*args),
                smt.processor_chain_plain(*args))


def test_eddsa_kernel_matches_plain(cuda):
    rng = np.random.default_rng(8)
    rows = []
    for i in range(8):
        prv = rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()
        pub = babyjub.prv2pub(prv)
        msg = int(rng.integers(0, 2**62))
        sig = babyjub.sign_poseidon(prv, msg)
        s = sig["S"] + [0, 1, 1 << 253, 1 << 252][i % 4]
        rows.append((pub[0], pub[1], s, sig["R8"][0], sig["R8"][1], msg))
    cols = [fr.pack([r[k] for r in rows]).to(cuda) for k in range(6)]
    ax, ay, s, r8x, r8y, msg = cols
    hm = poseidon.poseidon([r8x, r8y, ax, ay, msg]).contiguous()
    m = [fr.to_mont(c).contiguous() for c in (ax, ay, r8x, r8y)]
    args = (m[0], m[1], s, m[2], m[3], hm)
    got = babyjubjub.eddsa_ok_mont(*args)
    assert_same(got, babyjubjub.eddsa_ok_mont_plain(*args))
    assert got.tolist() == [True, False, True, False] * 2


@pytest.mark.parametrize("nblocks", [1, 3])
def test_sha256_kernel_matches_plain_and_hashlib(cuda, nblocks):
    rng = np.random.default_rng(nblocks)
    msgs = [rng.integers(0, 256, 64 * nblocks - 9, dtype=np.uint8).tobytes()
            for _ in range(LANES)]
    words = torch.tensor(
        [[int.from_bytes(m + b"\x80" + (8 * len(m)).to_bytes(8, "big"))
          >> (32 * (16 * nblocks - 1 - w)) & 0xFFFFFFFF
          for m in msgs] for w in range(16 * nblocks)],
        dtype=torch.int64, device=cuda)
    got = sha256.sha256_chain(words, nblocks)
    assert_same(got, sha256.sha256_chain_plain(words, nblocks))
    digest = b"".join(int(v).to_bytes(4, "big") for v in got[:, 7].tolist())
    assert digest == hashlib.sha256(msgs[7]).digest()


def test_engine_on_cuda_matches_builder_through_the_kernels(cuda):
    engine = RollupEngine(*SUITE_CONFIG, device=cuda)
    for name, bb in suite_batches().items():
        kernels.reset_launches()
        out, ok = engine.run(bb.get_input())
        assert ok, name
        want = oracle_outputs(bb)
        assert {k: out[k] for k in want} == want, name
        assert all(n > 0 for n in kernels.launches.values()), \
            (name, kernels.launches)
