"""Build, load and launch the hand-written CUDA kernels (csrc/).

The kernels are compiled by `nvcc` for `sm_90a` into ONE shared
library with a plain C interface and loaded with `ctypes` -- no PyTorch
headers, so a build takes seconds. The library is built at first use into
`build/` at the repository root, named by a hash of the sources, so an
edited source is rebuilt and an unchanged one is not.

Each op module owns a wrapper that checks its tensors, allocates outputs
with `torch.empty`, launches on `torch.cuda.current_stream()`, raises if
the C function reports a CUDA error, and adds one to `launches[name]`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("poseidon.cu", "smt.cu", "eddsa.cu", "sha256.cu",
           "poseidon_rounds.cu")
HEADERS = ("field.cuh", "poseidon.cuh")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# kernel name -> launches made by its wrapper; reset with reset_launches()
launches = {"poseidon_permute": 0, "smt_chain": 0, "eddsa_check": 0,
            "sha256_chain": 0, "poseidon_rounds_vpu": 0,
            "poseidon_rounds_mxu": 0}
# the kernels that RollupEngine.run launches; the other two belong to the
# full-round experiment (circuits_tpu_torch/scripts/exp_mxu_inkernel.py)
MAIN_PATH = ("poseidon_permute", "smt_chain", "eddsa_check", "sha256_chain")

_lib = None
_initialised_devices: set[int] = set()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libctpu_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing; returns its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        sigs = {
            "ctpu_poseidon_init": [P, I],
            "ctpu_smt_init": [P, I],
            "ctpu_poseidon_permute": [P, P, I, L, P],
            "ctpu_smt_chain": [P, P, P, P, P, P, P, I, L, P],
            "ctpu_eddsa_check": [P, P, P, P, P, P, P, P, L, P],
            "ctpu_sha256_chain": [P, P, I, L, P],
            "ctpu_rounds_init": [P, I],
            "ctpu_rounds_vpu": [P, P, I, L, P],
            "ctpu_rounds_mxu": [P, P, P, P, P, I, L, P],
        }
        for name, argtypes in sigs.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = so
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc} in {what}")


def prepare(device: torch.device) -> ctypes.CDLL:
    """The library, with the Poseidon constants uploaded to `device`'s
    __constant__ banks (once per device and process)."""
    from .convert import poseidon_kernel_words, rounds_kernel_words

    so = lib()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _initialised_devices:
        words = np.ascontiguousarray(poseidon_kernel_words())
        ptr = words.ctypes.data_as(ctypes.c_void_p)
        with torch.cuda.device(index):
            _check(so.ctpu_poseidon_init(ptr, words.shape[0]),
                   "ctpu_poseidon_init")
            _check(so.ctpu_smt_init(ptr, words.shape[0]), "ctpu_smt_init")
            rw = np.ascontiguousarray(rounds_kernel_words())
            _check(so.ctpu_rounds_init(rw.ctypes.data_as(ctypes.c_void_p),
                                       rw.shape[0]), "ctpu_rounds_init")
        _initialised_devices.add(index)
    return so


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(name: str, rc: int) -> None:
    """Record one launch of kernel `name`; raise on a CUDA error code."""
    _check(rc, name)
    launches[name] += 1
