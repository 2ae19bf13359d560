"""The one door from the port to the shared, jax-free host code.

The batch builder (`circuits_tpu/builder/`), the bigint field reference
(`circuits_tpu/field/scalar.py`), the Poseidon constant generator
(`circuits_tpu/ops/poseidon_constants.py`) and `circuits_tpu/utils/` hold
no JAX math, but `circuits_tpu/field/__init__.py` imports the JAX limb
kernels (`fr.py`). Before anything below `circuits_tpu.field` is imported,
this module registers `circuits_tpu.field` as a bare package module whose
`__init__` never runs, so `circuits_tpu.field.scalar` and everything that
depends on it import without JAX. Where the JAX package was imported first
(the comparison tests), the real package is already in `sys.modules` and
is used as it is.

Every module of `circuits_tpu_torch` reaches the shared code through the
names exported here; nothing from the builder is copied.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_FIELD = "circuits_tpu.field"


def _register_field_stub() -> None:
    if _FIELD in sys.modules:
        return
    import circuits_tpu  # noqa: F401  (the top package imports nothing)

    field_dir = Path(circuits_tpu.__file__).resolve().parent / "field"
    spec = importlib.util.spec_from_file_location(
        _FIELD, field_dir / "__init__.py",
        submodule_search_locations=[str(field_dir)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[_FIELD] = module
    circuits_tpu.field = module


_register_field_stub()

from circuits_tpu.field import scalar  # noqa: E402
from circuits_tpu.ops import poseidon_constants  # noqa: E402
from circuits_tpu.builder import babyjub, fee_table, float40  # noqa: E402
from circuits_tpu.builder.account import HermezAccount  # noqa: E402
from circuits_tpu.builder.rollup_db import RollupDB  # noqa: E402
from circuits_tpu.builder.smt import SMT  # noqa: E402
from circuits_tpu.builder.state_utils import Constants  # noqa: E402

__all__ = ["scalar", "poseidon_constants", "babyjub", "fee_table", "float40",
           "HermezAccount", "RollupDB", "SMT", "Constants"]
