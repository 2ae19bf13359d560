"""The plain reference: a frozen copy of the port's host batch builder
(RollupDB and BatchBuilder, the SMT, BabyJubJub and EdDSA, the Poseidon
constants with their native host hash, SHA-256, the Withdraw hash).

It makes every input of a cell from the seed and works out the outputs
that the circuit must give on them. It imports nothing of
`circuits_tpu_torch`, of the JAX package or of JAX; its native Poseidon is
built from `fr_poseidon.cpp` beside it into `build/portbench/` of the
checkout where g++ is at hand (the set-up line says which Poseidon ran).
"""
