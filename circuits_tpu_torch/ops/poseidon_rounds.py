"""R consecutive Poseidon t=3 full rounds: the full-round experiment.

Each round is ARK with the optimized schedule's `full_c[r % 8]`, x^5 on
every element, then the MDS mix new[i] = sum_j M[i][j] * state[j]. The
state is (16, 3, B) int64 -- limbs, element, lane -- in Montgomery form,
canonical in and out. Two formulations of the same rounds, each with a
kernel:

* `full_rounds_vpu` (K5, csrc/poseidon_rounds.cu): the mix as nine
  Montgomery products. Plain version `full_rounds_vpu_plain`.
* `full_rounds_mxu` (K6, same file): the mix as an integer matrix product
  on 8-bit limbs on the tensor cores (Wm of `convert.mix_matrices`, passed
  in fragment order as `convert.mix_fragments`), word carries and a
  Montgomery reduction in word rows, then one conditional subtract of p.
  Plain version `full_rounds_mxu_plain`: the mix and its reduction as
  three matrix products (Wm, Wn, Wp) in float64 (every column is below
  2^23, far inside float64's exact range) and byte carries.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. `full_rounds_py` is the bigint mirror both are held against.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..convert import ROUNDS_T, mix_fragments, mix_matrices, rounds_tables
from ..field import fr
from ..field import scalar
from . import poseidon_constants
from .poseidon import _pow5

N_LIMBS = fr.N_LIMBS
_F64 = torch.float64


@lru_cache(maxsize=None)
def _tables(device: torch.device):
    """CF (8, 16, 3, 1) and M (16, 3, 3, 1) int64 Montgomery limbs."""
    cf, m = rounds_tables()
    CF = torch.from_numpy(cf.astype("int64")).permute(0, 2, 1)[..., None]
    M = torch.from_numpy(m.astype("int64")).permute(2, 0, 1)[..., None]
    return CF.contiguous().to(device), M.contiguous().to(device)


@lru_cache(maxsize=None)
def _mix_fragments(device: torch.device) -> torch.Tensor:
    """K6's operand: Wm^T's B fragments, int32 words on `device`."""
    return torch.from_numpy(mix_fragments().view(np.int32)).to(device)


@lru_cache(maxsize=None)
def _mix_f64(device: torch.device):
    """Wm, Wn, Wp as float64 tensors on `device` (the plain version's)."""
    return tuple(torch.from_numpy(w).to(device, _F64) for w in mix_matrices())


def _ark_pow5(state: torch.Tensor, r: int) -> torch.Tensor:
    CF, _ = _tables(state.device)
    return _pow5(fr.add(state, CF[r % len(CF)]))


def full_rounds_vpu_plain(state: torch.Tensor, rounds: int) -> torch.Tensor:
    """`rounds` full rounds, the mix as Montgomery products; plain PyTorch.
    (16, 3, B) Montgomery in and out."""
    _, M = _tables(state.device)
    for r in range(rounds):
        s = _ark_pow5(state, r)
        prod = fr.mont_mul(M, s.unsqueeze(1))  # (16, t_out, t_in, B)
        state = fr.sum_list([prod[:, :, j] for j in range(ROUNDS_T)])
    return state


def _shift_up(c: torch.Tensor) -> torch.Tensor:
    """Column k's value moved to column k + 1 along axis 0 (zero fill; the
    top column's value drops out)."""
    return torch.cat([torch.zeros_like(c[:1]), c[:-1]], dim=0)


def _bytes_norm(cols: torch.Tensor) -> torch.Tensor:
    """Exact base-256 carry propagation: (n, *batch) int64 columns, each in
    [0, 2^23), -> the n bytes of their value mod 2^(8n). Two carry-save
    passes bring every column to at most 255 + 128; then a byte carries
    out exactly where it is >= 256, or is 255 with a carry in, and one
    carry look-ahead (`fr._lookahead`) finds the carry into each byte."""
    c = cols
    for _ in range(2):
        c = (c & 255) + _shift_up(c >> 8)
    carry = fr._lookahead(c > 255, c == 255)
    return (c + carry[:-1].to(c.dtype)) & 255


def _matmul_cols(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w (m, k) float64 times the byte rows x (k, *batch) -> (m, *batch)
    int64 columns; exact, since every sum stays below 2^53."""
    out = w @ x.reshape(x.shape[0], -1).to(_F64)
    return out.to(torch.int64).reshape((w.shape[0],) + x.shape[1:])


def _mix_mxu_plain(s: torch.Tensor) -> torch.Tensor:
    """The MDS mix with its Montgomery reduction on byte columns:
    (16, 3, B) canonical Montgomery -> (16, 3, B) canonical."""
    wm, wn, wp = _mix_f64(s.device)
    t, b = ROUNDS_T, s.shape[-1]
    # X[j*32 + 2i + h] = byte h of limb i of state[j]
    x8 = torch.stack([s & 255, s >> 8], dim=1)          # (16, 2, t, B)
    x8 = x8.permute(2, 0, 1, 3).reshape(t * 32, b)
    cols = _matmul_cols(wm, x8).reshape(t, 64, b).transpose(0, 1)
    T = _bytes_norm(cols)                               # (64, t, B): T < 2^512
    q = _bytes_norm(_matmul_cols(wn, T[:32]))           # lo * N' mod 2^256
    S = torch.cat([T, torch.zeros_like(T[:1])]) + _matmul_cols(wp, q)
    hi = _bytes_norm(S)[32:]                            # (T + q p) / 2^256
    limbs = torch.cat([hi[0:32:2] | (hi[1:32:2] << 8), hi[32:]])
    # hi < 1.6 p for t = 3: one conditional subtract makes it canonical
    return fr._sub_if_ge(limbs, scalar.P)[:N_LIMBS]


def full_rounds_mxu_plain(state: torch.Tensor, rounds: int) -> torch.Tensor:
    """`rounds` full rounds, the mix as byte matrix products; plain
    PyTorch. (16, 3, B) Montgomery in and out; equals
    `full_rounds_vpu_plain`."""
    for r in range(rounds):
        state = _mix_mxu_plain(_ark_pow5(state, r))
    return state


def _launch(name: str, state: torch.Tensor, rounds: int, plain, call):
    dev = state.device
    if dev.type == "cpu":
        return plain(state, rounds)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    b = state.shape[-1]
    kernels.require(state, "state", torch.int64, (N_LIMBS, ROUNDS_T, b), dev)
    if rounds < 0:
        raise ValueError(f"{name}: rounds={rounds} < 0")
    out = torch.empty_like(state)
    if b == 0:
        return out
    so = kernels.prepare(dev)
    kernels.launch(name, call(so, out))
    return out


def full_rounds_vpu(state: torch.Tensor, rounds: int) -> torch.Tensor:
    """(16, 3, B) Montgomery in/out. Wrapper of kernel K5."""
    return _launch(
        "poseidon_rounds_vpu", state, rounds, full_rounds_vpu_plain,
        lambda so, out: so.ctpu_rounds_vpu(
            kernels.ptr(state), kernels.ptr(out), rounds, state.shape[-1],
            kernels.stream_ptr(state.device)))


def full_rounds_mxu(state: torch.Tensor, rounds: int) -> torch.Tensor:
    """(16, 3, B) Montgomery in/out. Wrapper of kernel K6."""
    def call(so, out):
        return so.ctpu_rounds_mxu(
            kernels.ptr(state), kernels.ptr(out),
            kernels.ptr(_mix_fragments(state.device)), rounds,
            state.shape[-1], kernels.stream_ptr(state.device))

    return _launch("poseidon_rounds_mxu", state, rounds,
                   full_rounds_mxu_plain, call)


@lru_cache(maxsize=None)
def _optimized_constants():
    return poseidon_constants.optimized_constants(ROUNDS_T)


def full_rounds_py(state: list[int], rounds: int) -> list[int]:
    """Bigint mirror: `rounds` full rounds on one lane's three Montgomery
    values; returns Montgomery values."""
    P, R = scalar.P, scalar.R
    oc = _optimized_constants()
    s = [v * pow(R, -1, P) % P for v in state]
    for r in range(rounds):
        c = oc["full_c"][r % len(oc["full_c"])]
        s = [pow((x + c[i]) % P, 5, P) for i, x in enumerate(s)]
        s = [sum(oc["m"][i][j] * s[j] for j in range(ROUNDS_T)) % P
             for i in range(ROUNDS_T)]
    return [v * R % P for v in s]
