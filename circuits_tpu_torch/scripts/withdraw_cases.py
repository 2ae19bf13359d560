"""A batch of withdrawals for `WithdrawEngine`, built from the host tree:
an exit tree of random account leaves (builder/smt.py, with the leaf's
state hash from builder/state_utils.py) and one Withdraw input dict a
leaf, plus the tampered kinds that the circuit must refuse. The same
batches go to the engine on the CPU against the JAX package
(tests/test_torch_withdraw.py), to the engine on the card
(tests/test_torch_cuda.py) and to chip_smoke.py.
"""

from __future__ import annotations

from ..builder.smt import SMT
from ..builder.state_utils import hash_state
from ..field import scalar

# the kinds of tampered lane; each must give ok == False, for the reason
# named: the leaf's state hash, the proof's path, the key's path, and the
# range check on idx alone (bit nLevels of the key is above every level the
# proof walks, so the root still matches)
TAMPERS = ("balance", "sibling", "idx", "idx_range")


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


def exit_tree_batch(rng, n_leaves: int, n_levels: int) -> list[dict]:
    """`n_leaves` withdrawals out of one exit tree of as many random
    leaves, keys from 2 to 2^min(n_levels, 32): the input dicts of
    `WithdrawEngine.run`, every one valid. ethAddr is given as a hex
    string, as the builder gives it, in every other lane."""
    idxs = rng.sample(range(2, 1 << min(n_levels, 32)), n_leaves)
    states = [dict(tokenID=rng.randrange(1 << 32), nonce=0,
                   sign=rng.randrange(2), balance=rng.randrange(1 << 192),
                   ay=rng.randrange(scalar.P),
                   ethAddr=rng.randrange(1 << 160)) for _ in idxs]
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
    """A copy of a valid lane (whose proof has at least one sibling) with
    one of TAMPERS applied."""
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
