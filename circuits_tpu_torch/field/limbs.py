"""The host conversion between Python ints and field limbs (`csrc/limbs.c`).

A value of the field is 32 little-endian bytes on the host: its 16 uint16
limbs, limb 0 first (`fr.py`'s limbs). `write` turns a sequence of values,
or of rows padded with zeros to a width, into a caller's buffer of such
slots; `read` turns such bytes back into ints. Both run in a CPython
extension: an int in [0, P) is copied as it is, any other value goes
through the caller's reduction `read(v)` (`fr.pack_np`: `int(v) % P`).

The extension is compiled at first use with the host C compiler against
the running interpreter's headers (`sysconfig`), into `build/` at the
repository root, named by a hash of its source and the interpreter, and
loaded as a module; an unchanged source is not rebuilt. Nothing is built
when this module is imported. A build that fails raises: there is no
Python loop to fall back on, which would be some ten times slower.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

from .scalar import P

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "limbs.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NAME = "_ctpu_limbs"  # the module name that limbs.c's PyInit_ gives

_mod = None


def _compiler() -> str:
    cc = (sysconfig.get_config_var("CC") or "").split()[:1]
    for name in cc + ["cc", "gcc"]:
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(f"no C compiler found to build {SOURCE.name}")


def library_path() -> Path:
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(f"{include}\n{sys.version}".encode())
    return BUILD_DIR / f"{NAME}_{h.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile the extension if the one for the current source is missing;
    returns its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_compiler(), "-O2", "-shared", "-fPIC",
           f"-I{sysconfig.get_paths()['include']}", str(SOURCE), "-o",
           str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({res.returncode})"
                           f": {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, so)
    return so


def lib():
    """The loaded extension (built on first use), its modulus set to P."""
    global _mod
    if _mod is None:
        spec = importlib.util.spec_from_file_location(NAME, build())
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.modulus(P.to_bytes(32, "little"))
        _mod = mod
    return _mod


def write(values, out, width: int, pad: bool, read) -> int:
    """Write `values` into `out`, a writable C-contiguous buffer of 32
    bytes a value slot whose length says how many must come: with width 0
    a sequence of values, one a slot; with width > 0 a sequence of rows of
    `width` slots each, every row exactly `width` values long or, with
    `pad`, at most that and zero-filled past its end. An int in [0, P) is
    written as it is, any other value as `read(v)`, which returns an int in
    [0, P). Returns how many values took `read`."""
    return lib().write(values, out, width, pad, read)


def read(raw) -> list[int]:
    """A buffer of 32 little-endian bytes a value -> its ints."""
    return lib().read(raw)
