"""Batched Poseidon over BN254 Fr (circomlib semantics).

Layout: the permutation state is (16, t, B) -- limbs, Poseidon width,
lanes -- in Montgomery form, as in the JAX package. `permute_mont` is the
wrapper of kernel K1 (csrc/poseidon.cu): a CPU tensor takes the plain
version `permute_mont_plain`, a CUDA tensor launches the kernel. K1 runs
the sparse partial-round schedule (`poseidon_constants.optimized_constants`)
and so does the plain version by default; the dense circomlib schedule is
kept beside it (`schedule="dense"`) and gives the same values.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import kernels
from ..convert import (POSEIDON_WIDTHS, n_rounds, poseidon_sparse_tables,
                       poseidon_tables)
from ..field import fr

N_LIMBS = fr.N_LIMBS


def _limbs_first(a, device: torch.device) -> torch.Tensor:
    """(..., 16) uint32 limb table -> (16, ..., 1) int64 on `device`: limbs
    leading, a trailing lane axis to broadcast over."""
    x = torch.from_numpy(a.astype("int64")).movedim(-1, 0)[..., None]
    return x.contiguous().to(device)


@lru_cache(maxsize=None)
def _tables(t: int, device: torch.device):
    """Dense schedule: C (rounds, 16, t, 1) and M (16, t, t, 1)."""
    c, m = poseidon_tables(t)
    return _limbs_first(c, device).movedim(1, 0), _limbs_first(m, device)


@lru_cache(maxsize=None)
def _sparse_tables(t: int, device: torch.device) -> dict:
    """Sparse schedule, each part (16, ..., 1); the per-round parts with
    the round axis moved in front of the limbs."""
    tab = {k: _limbs_first(v, device)
           for k, v in poseidon_sparse_tables(t).items()}
    for k in ("full_c", "e", "sparse_row", "sparse_col"):
        tab[k] = tab[k].movedim(1, 0)
    tab["e"] = tab["e"].unsqueeze(2)  # (rp, 16, 1, 1): one element a round
    # a partial round's 2t - 1 products in one call: row then column
    tab["sparse"] = torch.cat([tab.pop("sparse_row"), tab.pop("sparse_col")],
                              dim=2)
    return tab


def _pow5(x: torch.Tensor) -> torch.Tensor:
    x2 = fr.mont_mul(x, x)
    x4 = fr.mont_mul(x2, x2)
    return fr.mont_mul(x4, x)


def _mix(M: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """new[i] = sum_j M[i][j] * state[j]; M (16, t, t, 1)."""
    prod = fr.mont_mul(M, state.unsqueeze(1))  # (16, t_out, t_in, B)
    return fr.sum_list([prod[:, :, j] for j in range(state.shape[1])])


def _permute_dense(state: torch.Tensor) -> torch.Tensor:
    t = state.shape[1]
    C, M = _tables(t, state.device)
    rf, rp = n_rounds(t)
    half = rf // 2
    for r in range(rf + rp):
        state = fr.add(state, C[r])
        if r < half or r >= half + rp:
            state = _pow5(state)
        else:
            state = torch.cat([_pow5(state[:, :1]), state[:, 1:]], dim=1)
        state = _mix(M, state)
    return state


def _full_round(state, c, M):
    """ARK + x^5 + mix; c (16, t, 1), M (16, t, t, 1)."""
    return _mix(M, _pow5(fr.add(state, c)))


def _partial_round(state, e, sparse):
    """One sparse partial round; e (16, 1, 1), sparse (16, 2t - 1, 1): the
    row then the column of the round's sparse factor."""
    t = state.shape[1]
    x0 = fr.add(_pow5(state[:, :1]), e)
    rest = state[:, 1:]
    prod = fr.mont_mul(sparse, torch.cat(
        [x0, rest, x0.expand_as(rest)], dim=1))
    new0 = fr.sum_list([prod[:, j] for j in range(t)])
    return torch.cat([new0[:, None], fr.add(rest, prod[:, t:])], dim=1)


def _permute_sparse(state: torch.Tensor) -> torch.Tensor:
    """The kernels' schedule (`optimized_constants`): rf/2 - 1 full rounds
    with m; one with pre_sparse, then + d; rp partial rounds, each
    x0 = x0^5 + e[r], new0 = sum_j sparse_row[r][j] * s[j],
    s[j] += sparse_col[r][j-1] * x0; rf/2 full rounds."""
    t = state.shape[1]
    tab = _sparse_tables(t, state.device)
    rf, rp = n_rounds(t)
    half = rf // 2
    for r in range(half):
        state = _full_round(state, tab["full_c"][r],
                            tab["m"] if r < half - 1 else tab["pre_sparse"])
    state = fr.add(state, tab["d"])
    for r in range(rp):
        state = _partial_round(state, tab["e"][r], tab["sparse"][r])
    for r in range(half, rf):
        state = _full_round(state, tab["full_c"][r], tab["m"])
    return state


def permute_mont_plain(state_m: torch.Tensor,
                       schedule: str = "sparse") -> torch.Tensor:
    """Full Poseidon permutation, plain PyTorch; state (16, t, B)
    Montgomery in and out. `schedule` is "sparse" (kernel K1's arithmetic)
    or "dense" (circomlib's round order); both give the same values."""
    if schedule == "sparse":
        return _permute_sparse(state_m)
    if schedule == "dense":
        return _permute_dense(state_m)
    raise ValueError(f"permute_mont_plain: unknown schedule {schedule!r}")


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
    out = torch.empty_like(state_m)
    if b == 0:
        return out
    so = kernels.prepare(dev)
    tab = kernels.poseidon_table(dev)
    kernels.launch("poseidon_permute", so.ctpu_poseidon_permute(
        kernels.ptr(state_m), kernels.ptr(out), kernels.ptr(tab),
        tab.shape[0], t, b, kernels.stream_ptr(dev)))
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
