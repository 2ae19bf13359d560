"""Account-state hashing + constants (commonjs stateUtils / Constants)."""

from __future__ import annotations

from .poseidon_constants import poseidon_py


def hash_state(state: dict) -> int:
    """Poseidon(4)(e0, balance, ay, ethAddr) with
    e0 = tokenID + nonce*2^32 + sign*2^72
    (reference: src/lib/hash-state.circom:18-40)."""
    e0 = (int(state["tokenID"])
          + int(state["nonce"]) * (1 << 32)
          + int(state["sign"]) * (1 << 72))
    ay = state["ay"]
    if isinstance(ay, str):
        ay = int(ay, 16)
    eth = state["ethAddr"]
    if isinstance(eth, str):
        eth = int(eth, 16)
    return poseidon_py([e0, int(state["balance"]), int(ay), int(eth)])


class Constants:
    """commonjs Constants (see SURVEY.md §8)."""

    firstIdx = 255   # first user account index - 1 (first account is 256)
    exitIdx = 1      # src/rollup-tx-states.circom:141 EXIT_IDX
    nullIdx = 0
    nullEthAddr = (1 << 160) - 1  # ETH_ADDR_ANY, src/rollup-tx-states.circom:131
    maxNlevels = 48
