"""Batched Poseidon over BN254 Fr (circomlib semantics).

Layout: the permutation state is (16, t, B) -- limbs, Poseidon width,
lanes -- in Montgomery form, as in the JAX package. `permute_mont` is the
wrapper of kernel K1 (csrc/poseidon.cu): a CPU tensor takes the plain
version `permute_mont_plain`, a CUDA tensor launches the kernel.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import kernels
from ..convert import n_rounds, poseidon_tables, POSEIDON_WIDTHS
from ..field import fr

N_LIMBS = fr.N_LIMBS


@lru_cache(maxsize=None)
def _tables(t: int, device: torch.device):
    """C (rounds, 16, t, 1) and M (16, t, t, 1) int64 Montgomery limbs."""
    c, m = poseidon_tables(t)
    C = torch.from_numpy(c.astype("int64")).permute(0, 2, 1)[..., None]
    M = torch.from_numpy(m.astype("int64")).permute(2, 0, 1)[..., None]
    return C.contiguous().to(device), M.contiguous().to(device)


def _pow5(x: torch.Tensor) -> torch.Tensor:
    x2 = fr.mont_mul(x, x)
    x4 = fr.mont_mul(x2, x2)
    return fr.mont_mul(x4, x)


def permute_mont_plain(state_m: torch.Tensor) -> torch.Tensor:
    """Full Poseidon permutation (dense schedule), plain PyTorch; state
    (16, t, B) Montgomery in and out."""
    t = state_m.shape[1]
    C, M = _tables(t, state_m.device)
    rf, rp = n_rounds(t)
    half = rf // 2
    state = state_m
    for r in range(rf + rp):
        state = fr.add(state, C[r])
        if r < half or r >= half + rp:
            state = _pow5(state)
        else:
            state = torch.cat([_pow5(state[:, :1]), state[:, 1:]], dim=1)
        prod = fr.mont_mul(M, state.unsqueeze(1))  # (16, t_out, t_in, B)
        state = fr.sum_list([prod[:, :, j] for j in range(t)])
    return state


def permute_mont(state_m: torch.Tensor) -> torch.Tensor:
    """(16, t, B) Montgomery in/out, t = 3..7. Wrapper of kernel K1."""
    dev = state_m.device
    if dev.type == "cpu":
        return permute_mont_plain(state_m)
    if dev.type != "cuda":
        raise ValueError(f"permute_mont: unsupported device {dev}")
    t, b = state_m.shape[1], state_m.shape[2]
    if t not in POSEIDON_WIDTHS:
        raise ValueError(f"permute_mont: width t={t} not in 3..7")
    kernels.require(state_m, "state_m", torch.int64, (N_LIMBS, t, b), dev)
    so = kernels.prepare(dev)
    out = torch.empty_like(state_m)
    kernels.launch("poseidon_permute", so.ctpu_poseidon_permute(
        kernels.ptr(state_m), kernels.ptr(out), t, b,
        kernels.stream_ptr(dev)))
    return out


def poseidon(inputs: list) -> torch.Tensor:
    """Poseidon hash of n canonical (16, *batch) elements -> (16, *batch);
    circomlib `Poseidon(n)`."""
    t = len(inputs) + 1
    bshape = torch.broadcast_shapes(*[x.shape[1:] for x in inputs])
    flat = [x.expand((N_LIMBS,) + tuple(bshape)).reshape(N_LIMBS, -1)
            for x in inputs]
    state = torch.stack([torch.zeros_like(flat[0])] + flat, dim=1)
    state = permute_mont(fr.to_mont(state).contiguous())
    out = fr.from_mont(state[:, 0])
    return out.reshape((N_LIMBS,) + tuple(bshape))
