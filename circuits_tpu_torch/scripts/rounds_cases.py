"""Hard lanes for the full-round experiment (kernels K5 and K6,
ops/poseidon_rounds.py): the same lanes go to the plain versions against
the bigint mirror on the CPU (tests/test_torch_poseidon_rounds.py), to the
kernels against their plain versions on the card (tests/test_torch_cuda.py)
and to chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import rounds_tables
from ..field import fr, scalar

P, R = scalar.P, scalar.R


def sbox_preimage(y_mont: int, c_mont: int) -> int:
    """The Montgomery value x whose round-0 ARK + x^5 gives the Montgomery
    value y_mont (x^5 permutes Fr, since gcd(5, p - 1) = 1)."""
    rinv = pow(R, -1, P)
    a = pow(y_mont * rinv % P, pow(5, -1, P - 1), P)
    return (a - c_mont * rinv) * R % P


def edge_values() -> list[int]:
    """Canonical values with runs of 0xFF bytes, the field's ends, and
    Montgomery one."""
    runs = [(1 << 248) - 1, (1 << 253) - 1, ((1 << 248) - 1) ^ (0xFF << 120),
            (1 << 253) - (1 << 8), P - 1 - (1 << 200)]
    return [0, 1, P - 1, R % P] + runs


def round_constants() -> list[list[int]]:
    """The experiment's `full_c` (round r adds row r % 8) as Montgomery
    values, 8 rows of 3."""
    cf, _ = rounds_tables()
    return [[int(fr.unpack_np(torch.from_numpy(cf[r, e].astype(np.int64))))
             for e in range(3)] for r in range(len(cf))]


def edge_lanes(seed: int = 21):
    """(16, 3, lanes) int64 Montgomery limbs on the CPU and the values as 3
    lists of ints: every edge value in all three elements; lanes whose
    round-0 S-box outputs are the edge values, so that the mix reads byte
    columns full of 0xFF; the edge values mixed across elements; and 8
    random lanes from `seed`."""
    c0 = round_constants()[0]
    ev = edge_values()
    lanes = [[v, v, v] for v in ev]
    lanes += [[sbox_preimage(v, c0[e]) for e in range(3)] for v in ev]
    lanes += [[ev[i], ev[(i + 3) % len(ev)], ev[(i + 5) % len(ev)]]
              for i in range(len(ev))]
    rng = np.random.default_rng(seed)
    lanes += [[int(v) % P for v in rng.integers(0, 1 << 63, 3)]
              for _ in range(8)]
    vals = [[lane[e] for lane in lanes] for e in range(3)]
    return fr.pack(vals), vals
