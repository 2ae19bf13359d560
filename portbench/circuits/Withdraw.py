"""Withdraw(nLevels): the traffic's build from the seed's generator and the
reference's answers.

Keys of a Withdraw mix file:
  entry          "withdraw.run" (`WithdrawEngine.run`)
  trees, leaves_per_tree
                 exit trees of random leaves (keys 2 .. 2^min(nLevels, 32))
  tampered_per_lane
                 the share of claims that are altered so that the circuit
                 must refuse them (balance, sibling, idx, idx range)
  lanes_per_call, orders
                 the lanes of all trees are cut into calls of this many in
                 each of `orders` seeded permutations
  profile_calls  calls the traced run profiles
"""

from __future__ import annotations

import time

from portbench.metrics import workcount
from portbench.reference.withdraw_utils import hash_inputs_withdraw
from portbench.traffic import TAMPERS, Load, exit_tree_lanes, tamper


def build(config: dict, mix: dict, rng) -> Load:
    n_levels = config["nLevels"]
    t = time.perf_counter()
    lanes = []
    for _ in range(mix["trees"]):
        lanes += exit_tree_lanes(rng, mix["leaves_per_tree"], n_levels)
    n_bad = round(mix["tampered_per_lane"] * len(lanes))
    valid = [True] * len(lanes)
    for k, pos in enumerate(rng.sample(range(len(lanes)), n_bad)):
        lanes[pos] = tamper(lanes[pos], TAMPERS[k % len(TAMPERS)], n_levels)
        valid[pos] = False
    secs = {"trees": time.perf_counter() - t}
    width = mix["lanes_per_call"]
    if len(lanes) % width:
        raise ValueError(f"{len(lanes)} lanes do not cut into calls of "
                         f"{width}")
    items, expected, work = [], [], []
    for _ in range(mix["orders"]):
        perm = rng.sample(range(len(lanes)), len(lanes))
        for start in range(0, len(perm), width):
            pos = perm[start:start + width]
            items.append([lanes[p] for p in pos])
            # the hashes are worked out once the window has closed (answers)
            expected.append(dict(lanes=pos, ok=[valid[p] for p in pos]))
            work.append(workcount.withdraw_work(items[-1], n_levels))
    return Load("Withdraw", items, list(range(len(items))), expected, work,
                secs)


def answer(load: Load, i: int) -> None:
    """Item i's `hash` a lane, the SHA-256 of its public fields, once."""
    exp = load.expected[i]
    if "hash" not in exp:
        exp["hash"] = [hash_inputs_withdraw(d) for d in load.items[i]]
