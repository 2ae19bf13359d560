"""ctypes loader for the reference's native host Poseidon (fr_poseidon.cpp
beside this file).

The batch builder's sequential SMT chain is Poseidon-bound, so the host
hash runs in C++ where a compiler is at hand. `library()` builds the
shared object with g++ at first use into `build/portbench/` of the checkout
(named by a hash of the source), installs the circomlib constants
(generated in Python, converted to Montgomery form) and returns it; where
there is no source or no compiler it returns None and the caller keeps
the pure-Python hash. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from .scalar import P

_R = (1 << 256) % P

_ROOT = Path(__file__).resolve().parents[2]
_SRC = Path(__file__).resolve().parent / "fr_poseidon.cpp"
_BUILD_DIR = _ROOT / "build" / "portbench"

_lib = None
_tried = False
_installed_t: set[int] = set()


def _build() -> Path | None:
    gxx = shutil.which("g++")
    if gxx is None or not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"libfr_poseidon_{digest}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(
        [gxx, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
        capture_output=True, timeout=120)
    if res.returncode != 0:
        return None
    os.replace(tmp, so)
    return so


def library():
    """The loaded native library, or None where it cannot be built."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.poseidon_hash.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                  ctypes.c_char_p]
    lib.poseidon_hash.restype = None
    lib.set_poseidon_params.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_char_p, ctypes.c_char_p]
    lib.set_poseidon_params.restype = None
    _lib = lib
    return _lib


def _le_bytes(x: int) -> bytes:
    return (x % P).to_bytes(32, "little")


def _install_constants(lib, t: int) -> None:
    from .poseidon_constants import N_ROUNDS_P, constants

    if t in _installed_t:
        return
    C, M = constants(t)
    cbuf = b"".join(_le_bytes((c * _R) % P) for c in C)
    mbuf = b"".join(_le_bytes((M[i][j] * _R) % P)
                    for i in range(t) for j in range(t))
    lib.set_poseidon_params(t, N_ROUNDS_P[t - 2], cbuf, mbuf)
    _installed_t.add(t)


def poseidon_native(lib, inputs: list[int]) -> int:
    """Drop-in for poseidon_py_pure (canonical int inputs/output) on the
    library `library()` returned."""
    t = len(inputs) + 1
    _install_constants(lib, t)
    ibuf = b"".join(_le_bytes(x) for x in inputs)
    obuf = ctypes.create_string_buffer(32)
    lib.poseidon_hash(t, ibuf, obuf)
    return int.from_bytes(obuf.raw, "little")
