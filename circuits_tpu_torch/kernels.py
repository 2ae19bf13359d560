"""Build, load and launch the hand-written CUDA kernels (csrc/).

The kernels are compiled by `nvcc` for `sm_90a` into ONE shared
library with a plain C interface and loaded with `ctypes` -- no PyTorch
headers, so a build takes seconds. The library is built
at first use into `build/` at the repository root, named by a hash of the
sources, so an edited source is rebuilt and an unchanged one is not. Each
source is compiled by its own `nvcc`, all started together, and the objects
are linked at the end; what `-Xptxas -v` said of each kernel (registers,
spills, shared memory) is kept beside the library (`build_log`).

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
           "poseidon_rounds.cu", "mont_rate.cu", "ay_sign.cu")
HEADERS = ("field.cuh", "poseidon.cuh", "funcs.cuh")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# kernel name -> launches made by its wrapper; reset with reset_launches()
launches = {"poseidon_permute": 0, "smt_chain": 0, "eddsa_check": 0,
            "sha256_chain": 0, "poseidon_rounds_vpu": 0,
            "poseidon_rounds_mxu": 0, "ay_sign_to_ax": 0}
# the kernels that RollupEngine.run launches; the rounds kernels belong to
# the full-round experiment (circuits_tpu_torch/scripts/exp_mxu_inkernel.py)
MAIN_PATH = ("poseidon_permute", "smt_chain", "eddsa_check", "sha256_chain",
             "ay_sign_to_ax")
# C function that reports a source's __global__ functions (csrc/funcs.cuh)
# -> the launches key of each, in the order it writes their handles
FUNCS = {"ctpu_poseidon_funcs": ("poseidon_permute", "poseidon_permute"),
         "ctpu_smt_funcs": ("smt_chain",),
         "ctpu_eddsa_funcs": ("eddsa_check",),
         "ctpu_sha256_funcs": ("sha256_chain", "sha256_chain"),
         "ctpu_rounds_funcs": ("poseidon_rounds_vpu", "poseidon_rounds_mxu"),
         "ctpu_ay_sign_funcs": ("ay_sign_to_ax",)}

_lib = None
_prepared: dict[int, torch.Tensor] = {}
_functions: dict[int, dict[int, str]] = {}


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
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", "-c", str(CSRC / s), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)]
    outs = [p.communicate()[0] for p in procs]
    try:
        for s, p, out in zip(SOURCES, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {s} ({p.returncode}):\n{out}")
        tmp = BUILD_DIR / f"{tag}.tmp"
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to link ({res.returncode}):\n{res.stderr}")
        so.with_suffix(".log").write_text("".join(
            f"== {s}\n{out}" for s, out in zip(SOURCES, outs)))
        os.replace(tmp, so)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return so


def build_log() -> str:
    """What `nvcc -Xptxas -v` printed when the current library was built
    (empty if it was built by another tree)."""
    log = build().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        sigs = {
            "ctpu_poseidon_permute": [P, P, P, I, I, L, P],
            "ctpu_smt_chain": [P, P, P, P, P, P, P, P, I, I, L, P],
            "ctpu_eddsa_check": [P, P, P, P, P, P, P, P, L, P],
            "ctpu_sha256_chain": [P, P, I, L, P],
            "ctpu_sha256_narrow_lanes": [P],
            "ctpu_rounds_init": [P, I],
            "ctpu_rounds_vpu": [P, P, I, L, P],
            "ctpu_rounds_mxu": [P, P, P, I, L, P],
            "ctpu_mont_rate": [P, I, I, I, I, P],
            "ctpu_ay_sign_to_ax": [P, P, P, P, L, P],
            **{name: [P] for name in FUNCS},
        }
        for name, argtypes in sigs.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = so
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a CUDA error code returned by a C function."""
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc} in {what}")


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def prepare(device: torch.device) -> ctypes.CDLL:
    """The library, with `device` set up for the kernels (once per device
    and process): K5/K6's constants in their __constant__ bank, and the
    Poseidon constant table of K1 and K2 in device memory."""
    from .convert import poseidon_kernel_words, rounds_kernel_words

    so = lib()
    index = _index(device)
    if index not in _prepared:
        with torch.cuda.device(index):
            rw = np.ascontiguousarray(rounds_kernel_words())
            check(so.ctpu_rounds_init(rw.ctypes.data_as(ctypes.c_void_p),
                                       rw.shape[0]), "ctpu_rounds_init")
        words = np.ascontiguousarray(poseidon_kernel_words()).view(np.int32)
        _prepared[index] = torch.from_numpy(words).to(
            torch.device("cuda", index))
    return so


def poseidon_table(device: torch.device) -> torch.Tensor:
    """`convert.poseidon_kernel_words()` as an int32 tensor (n_elements, 8)
    in `device`'s memory; `prepare(device)` has put it there."""
    return _prepared[_index(device)]


def functions(device: torch.device) -> dict[int, str]:
    """{CUfunction handle of a kernel of the library on `device`:
    its launches key}, each kernel's handle as the runtime gives it
    (`cudaGetFuncBySymbol`): what a captured graph's kernel nodes name."""
    index = _index(device)
    if index not in _functions:
        so, found = prepare(device), {}
        with torch.cuda.device(index):
            for fn, names in FUNCS.items():
                out = (ctypes.c_void_p * len(names))()
                check(getattr(so, fn)(out), fn)
                found.update({h: name for h, name in zip(out, names)})
        if None in found or len(found) != sum(map(len, FUNCS.values())):
            raise RuntimeError(f"kernel handles not distinct: {found}")
        _functions[index] = found
    return _functions[index]


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
    check(rc, name)
    launches[name] += 1
