"""Analytic R1CS constraint-count model.

Closed-form per-component formulas replicated from the reference's
estimator (tools/circuit-constraints.js:31-63). These are
the reference's own cost model — used by the CLI to report the constraint
mass a given parametrization represents, and by benchmarks to convert
witness throughput into constraints/sec.
"""

from __future__ import annotations


def decode_tx(n_levels: int) -> int:
    return 4 * n_levels + 1473           # circuit-constraints.js:31-34


def fee_tx(n_levels: int) -> int:
    return 483 * n_levels + 2592         # circuit-constraints.js:36-39


def rollup_tx(n_levels: int, max_fee_tx: int) -> int:
    return 974 * n_levels + 14552 + 5 * max_fee_tx  # :41-44


def bits_l1_tx_full_data() -> int:
    return 2 * 48 + 32 + 40 + 40 + 256 + 160   # src/decode-tx.circom:73


def bits_l1l2_tx_data(n_levels: int) -> int:
    return 2 * n_levels + 40 + 8


def hash_inputs(n_tx: int, n_levels: int, max_l1_tx: int,
                max_fee_tx: int) -> int:
    bits_l1 = max_l1_tx * bits_l1_tx_full_data()
    bits_l2 = n_tx * bits_l1l2_tx_data(n_levels)
    bits_fee = max_fee_tx * n_levels
    total_bits = (2 * 48 + 3 * 256 + 16 + 32 + bits_l1 + bits_l2
                  + bits_fee)
    sha = 28953 + 29305 * ((total_bits + 64) // 512)  # :56
    wiring = 2 * bits_l1 + 2 * bits_l2 + (48 + 2 * n_levels) * max_fee_tx
    return sha + wiring


def im_signals(n_tx: int, max_fee_tx: int) -> int:
    return (6 * n_tx + (2 + max_fee_tx) * 2 * n_tx
            + 2 * (1 + 2 * max_fee_tx))  # :61-63


def total_constraints(n_tx: int, n_levels: int, max_l1_tx: int,
                      max_fee_tx: int) -> int:
    return (n_tx * (decode_tx(n_levels) + rollup_tx(n_levels, max_fee_tx))
            + max_fee_tx * fee_tx(n_levels)
            + hash_inputs(n_tx, n_levels, max_l1_tx, max_fee_tx)
            + im_signals(n_tx, max_fee_tx))
