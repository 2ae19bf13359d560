"""The capture-safety mirror of the port's compiled routes
(`circuits_tpu_torch/engine/aot.py`), shared by the test files that hold a
route to it: every aten op of one call is recorded on the CPU under a
`TorchDispatchMode`, and an op that a CUDA-graph capture refuses is kept
with the line of the port that called it."""

import collections
import traceback

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from circuits_tpu_torch.ops import babyjubjub, poseidon, sha256, smt

# ops a CUDA-graph capture refuses: a tensor made from host data (a
# synchronous copy from pageable memory on the card), a value read back to
# the host, an output whose shape depends on the data
REFUSED = {"lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "nonzero",
           "masked_select", "equal", "is_nonzero", "_unique2",
           "unique_consecutive", "unique_dim", "bincount"}
# the plain versions of K1-K4 and AySign2Ax: they run only on the CPU, and
# on the card the kernels take their place
PLAIN = ((poseidon, "permute_mont_plain"), (smt, "processor_chain_plain"),
         (babyjubjub, "eddsa_ok_mont_plain"), (sha256, "sha256_chain_plain"),
         (babyjubjub, "ay_sign_to_ax_plain"))


class OpRecorder(TorchDispatchMode):
    """Counts every aten op; keeps where each refused op was called from.
    Nothing is recorded while `paused`."""

    def __init__(self):
        super().__init__()
        self.count = 0
        self.paused = 0
        self.refused = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            self.count += 1
            name = func.overloadpacket.__name__
            bool_index = name in ("index", "index_put", "index_put_") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ()) or ())
            if name in REFUSED or bool_index:
                frame = [f for f in traceback.extract_stack()
                         if "circuits_tpu_torch" in f.filename][-1]
                self.refused[(str(func), frame.filename.rsplit("/", 2)[-1],
                              frame.lineno)] += 1
        return func(*args, **kwargs)


def record_ops(monkeypatch, run) -> OpRecorder:
    """`run()` under an OpRecorder, the kernels' plain versions paused:
    they run with the mode taken off, so their ops are neither recorded
    nor slowed by it."""
    rec = OpRecorder()
    for mod, name in PLAIN:
        real = getattr(mod, name)

        def paused(*a, _real=real, **k):
            rec.paused += 1
            try:
                with _disable_current_modes():
                    return _real(*a, **k)
            finally:
                rec.paused -= 1

        monkeypatch.setattr(mod, name, paused)
    with rec:
        run()
    return rec
