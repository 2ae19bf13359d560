"""circuits_tpu_torch -- the PyTorch/CUDA port of the circuits_tpu witness
engine.

Layers, mirroring `circuits_tpu/`:
  host.py   the jax-free door to the shared builder and constant code
  field/    BN254 Fr limb arithmetic (plain PyTorch)
  ops/      Poseidon, SMT processor, BabyJubJub/EdDSA, SHA-256, gadgets;
            each op with a hand-written CUDA kernel has its plain PyTorch
            version beside the wrapper
  models/   the RollupMain circuit templates as batched evaluators
  engine/   input packing and the RollupEngine entry point
  csrc/     the CUDA C++ kernels (built on first use, see kernels.py)

Tensors on the CPU take the plain versions; tensors on a CUDA device
launch the kernels.
"""

__version__ = "0.1.0"
