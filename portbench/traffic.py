"""The one traffic generator: a configuration and a mix in, a cell's calls
out, every value drawn from the seed.

A configuration (`configs/<name>.json`) names its circuit and sizes; a mix
(`traffic/<name>.json`) is data: the entry point it drives (`entry`, a
file `routes/<entry>.py`), how the calls' inputs are made and in what
order the window cycles them, and `profile_calls`, the calls the traced
run profiles. Every seed gets the same sizes and the same amount of work
in another order: the seed draws the keys, the leaves and the
permutations, never a count. What a circuit's mix holds, and how its
calls are made, is the circuit's own file, `circuits/<circuit>.py` (its
`build(config, mix, rng)` and `answer(load, i)`); what they share is
here.

`build` returns a `Load`: the calls' inputs (`items`), the order the
window cycles them in, each item's circuit work (`metrics/workcount.py`)
and the expected outputs, which `judge.py` holds the program's against.
What the reference works out only to judge (a batch's hash of its global
inputs, a Withdraw lane's hash) is worked out once the window has closed
(`answers`), out of the set-up.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from pathlib import Path

from . import files
from .reference import babyjub, tx_utils
from .reference.smt import SMT
from .reference.state_utils import hash_state
from .reference.scalar import P

ROOT = Path(__file__).resolve().parent.parent

TAMPERS = ("balance", "sibling", "idx", "idx_range")


class Account:
    """A rollup account drawn from the seed: its BabyJubJub key's 32 bytes
    and, beside them, its Ethereum address (the circuit never ties the
    address to a key, so it is drawn, not derived: secp256k1 and keccak in
    pure Python would take most of the set-up)."""

    def __init__(self, rng):
        self.private_key = rng.randbytes(32)
        self.ethAddr = f"0x{rng.getrandbits(160):040x}"
        self.bjjCompressed = babyjub.pack_point(
            babyjub.prv2pub(self.private_key)).hex()

    def sign_tx(self, tx: dict) -> None:
        tx_utils.sign_tx(tx, self.private_key)


@dataclass
class Load:
    circuit: str
    items: list            # one call's input: a dict (RollupMain) or a list
    order: list[int]       # the window cycles items in this order
    expected: list         # a dict an item (`judge.py` reads it)
    work: list[dict]       # an item's circuit work (`metrics/workcount.py`)
    seconds: dict = field(default_factory=dict)  # parts of the build
    builders: list = field(default_factory=list)  # an item's BatchBuilder
    root: Path = ROOT      # the checkout its circuit's file was found in


def build(root: Path, config: dict, mix: dict, seed: int) -> Load:
    """The cell's `Load`, drawn from `seed` by `build` of
    `circuits/<circuit>.py` under the checkout `root`."""
    circuit = files.load(root, "circuits", config["circuit"])
    load = circuit.build(config, mix, random.Random(seed))
    load.root = root
    return load


def bulk_tree(items: list[tuple[int, int]]) -> SMT:
    """The tree that inserting every (key, value) of `items` one by one
    gives (the compressed SMT is canonical for a set of leaves), built
    bottom-up with each node hashed once: a subtree with no leaf is 0, one
    with a single leaf is that leaf, any other the hash of its halves by the
    key's next bit, LSB first."""
    tree = SMT()

    def node(sub, level):
        if not sub:
            return 0
        if len(sub) == 1:
            return tree._put_leaf(*sub[0])
        halves = [], []
        for kv in sub:
            halves[(kv[0] >> level) & 1].append(kv)
        return tree._put_node(node(halves[0], level + 1),
                              node(halves[1], level + 1))

    tree.root = node(list(items), 0)
    return tree


def exit_tree_lanes(rng, n_leaves: int, n_levels: int) -> list[dict]:
    """`n_leaves` withdrawals out of one exit tree of as many random leaves:
    the input dicts of `WithdrawEngine.run`, every one valid. ethAddr is a
    hex string, as the builder gives it, in every other lane."""
    idxs = rng.sample(range(2, 1 << min(n_levels, 32)), n_leaves)
    states = [dict(tokenID=rng.randrange(1 << 32), nonce=0,
                   sign=rng.randrange(2), balance=rng.randrange(1 << 192),
                   ay=rng.randrange(P), ethAddr=rng.randrange(1 << 160))
              for _ in idxs]
    tree = bulk_tree([(idx, hash_state(st))
                      for idx, st in zip(idxs, states)])
    lanes = []
    for lane, (idx, st) in enumerate(zip(idxs, states)):
        eth = hex(st["ethAddr"]) if lane % 2 else st["ethAddr"]
        lanes.append(dict(rootExit=tree.root, ethAddr=eth,
                          tokenID=st["tokenID"], balance=st["balance"],
                          idx=idx, sign=st["sign"], ay=st["ay"],
                          siblingsState=tree.find(idx).siblings))
    return lanes


def tamper(lane: dict, kind: str, n_levels: int) -> dict:
    """A copy of a valid lane (whose proof has at least one sibling) that
    the circuit must refuse: the leaf's state hash, the proof's path, the
    key's path, or the range check on idx alone."""
    bad = dict(lane)
    if kind == "balance":
        bad["balance"] = lane["balance"] + 1
    elif kind == "sibling":
        sib = list(lane["siblingsState"])
        sib[0] ^= 1
        bad["siblingsState"] = sib
    elif kind == "idx":
        bad["idx"] = lane["idx"] ^ 1
    elif kind == "idx_range":
        bad["idx"] = lane["idx"] + (1 << n_levels)
    else:
        raise ValueError(f"unknown tamper {kind!r}")
    return bad


def answers(load: Load, used: set) -> None:
    """Fill each used item's expected answers that the reference works out
    only to judge, once the window has closed (`answer` of
    `circuits/<circuit>.py`): a RollupMain batch's `hash_global_inputs`,
    a Withdraw item's `hash` a lane."""
    circuit = files.load(load.root, "circuits", load.circuit)
    for i in used:
        circuit.answer(load, i)
