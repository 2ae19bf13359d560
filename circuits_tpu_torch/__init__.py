"""circuits_tpu_torch -- the PyTorch/CUDA port of the circuits_tpu witness
engine. The package stands alone: it imports torch and numpy, never jax and
nothing of the JAX package.

Layers, mirroring `circuits_tpu/`:
  field/    BN254 Fr limb arithmetic (plain PyTorch, `fr.py`) and the
            bigint reference (`scalar.py`)
  ops/      Poseidon, SMT processor, BabyJubJub/EdDSA, SHA-256, gadgets;
            each op with a hand-written CUDA kernel has its plain PyTorch
            version beside the wrapper; `poseidon_constants.py` generates
            the constants; `poseidon_mxu.py` is the permutation on 8-bit
            limbs with matrix products, a function beside `permute_mont`
  models/   the RollupMain circuit templates as batched evaluators
  engine/   input packing and the RollupEngine entry point
  builder/  the host-side batch builder (RollupDB, SMT, accounts, txs)
  utils/    host hashes (blake512, keccak, SHA-256) and the loader of the
            native host Poseidon
  tools/    the CLI (`python -m circuits_tpu_torch.tools.cli <verb>`)
  csrc/     the CUDA C++ kernels (built on first use, see kernels.py)

The entry points (`RollupEngine`, `pack_rollup_inputs`) run on the card
("cuda") unless the caller names a device, and raise where there is no
card. Below them the tensors' device decides: a tensor on the CPU takes a
kernel's plain version, a tensor on a CUDA device launches the kernel or
raises.
"""

__version__ = "0.1.0"
