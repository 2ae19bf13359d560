"""The one traffic generator: a configuration and a mix in, a cell's calls
out, every value drawn from the seed.

A configuration (`configs/<name>.json`) names its circuit and sizes; a mix
(`traffic/<name>.json`) is data: the entry point it drives, how the calls'
inputs are made and in what order the window cycles them. Every seed gets
the same sizes and the same amount of work in another order: the seed
draws the keys, the leaves and the permutations, never a count.

RollupMain mixes (keys of the mix file):
  entry          "rollup.run" (`RollupEngine.run`)
  token, load_amount, user_fee
                 the token every account holds, each account's deposit
                 and the fee selector of every transfer
  batches        one object a distinct batch, built from the one
                 populated state: `step` (the ring's offset: lane k of the
                 seeded ring pays lane k + step), `amount`, and optionally
                 `l1_deposits` (new accounts deposited first, at most
                 maxL1Tx) and `l2_transfers` (default: the lanes left);
                 lanes beyond both are NOP
  refused_copies the positions of batches of which a copy with one L2
                 lane's signature altered (the lane drawn from the seed)
                 joins the calls: the circuit must refuse it (ok False),
                 with the original's roots, fee tail and hash, since a
                 signature feeds only the EdDSA check
  profile_calls  calls the traced run profiles
Withdraw mixes:
  entry          "withdraw.run" (`WithdrawEngine.run`)
  trees, leaves_per_tree
                 exit trees of random leaves (keys 2 .. 2^min(nLevels, 32))
  tampered_per_lane
                 the share of claims that are altered so that the circuit
                 must refuse them (balance, sibling, idx, idx range)
  lanes_per_call, orders
                 the lanes of all trees are cut into calls of this many in
                 each of `orders` seeded permutations
  profile_calls  as above

`build` returns a `Load`: the calls' inputs (`items`), the order the
window cycles them in, each item's circuit work (`metrics/workcount.py`)
and the expected outputs, which `judge.py` holds the program's against.
What the reference works out only to judge (a batch's hash of its global
inputs, a Withdraw lane's hash) is worked out once the window has closed
(`answers`), out of the set-up.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

from .reference import babyjub, float40, tx_utils
from .reference.rollup_db import RollupDB
from .reference.smt import SMT
from .reference.state_utils import hash_state
from .reference.scalar import P
from .reference.withdraw_utils import hash_inputs_withdraw
from .metrics import workcount

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


def build(config: dict, mix: dict, seed: int) -> Load:
    rng = random.Random(seed)
    if config["circuit"] == "RollupMain":
        return _rollup(config, mix, rng)
    if config["circuit"] == "Withdraw":
        return _withdraw(config, mix, rng)
    raise ValueError(f"unknown circuit {config['circuit']!r}")


def _rollup(config: dict, mix: dict, rng) -> Load:
    n_tx, n_levels = config["nTx"], config["nLevels"]
    max_l1, max_fee = config["maxL1Tx"], config["maxFeeTx"]
    params = (n_tx, n_levels, max_l1, max_fee)
    token, load = mix["token"], float40.fix2float(mix["load_amount"])
    secs = {}
    t = time.perf_counter()
    n_keys = n_tx + sum(b.get("l1_deposits", 0) for b in mix["batches"])
    accounts = [Account(rng) for _ in range(n_keys)]
    depositors = iter(accounts[n_tx:])
    secs["accounts"] = time.perf_counter() - t

    def deposit(bb, acc):
        bb.add_tx(dict(fromIdx=0, loadAmountF=load, tokenID=token,
                       fromBjjCompressed=acc.bjjCompressed,
                       fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))

    # the populated state: every account by an L1 deposit, maxL1Tx a batch
    t = time.perf_counter()
    db = RollupDB()
    for start in range(0, n_tx, max_l1):
        bb = db.build_batch(*params)
        for acc in accounts[start:min(start + max_l1, n_tx)]:
            deposit(bb, acc)
        bb.build()
        db.consolidate(bb)
    first = db.last_idx - n_tx + 1  # the first account's idx
    secs["populate"] = time.perf_counter() - t

    items, expected, work, builders = [], [], [], []
    secs["sign"] = secs["build"] = 0.0
    for spec in mix["batches"]:
        n_l1 = spec.get("l1_deposits", 0)
        n_l2 = spec.get("l2_transfers", n_tx - n_l1)
        if n_l1 > max_l1 or n_l1 + n_l2 > n_tx or n_l2 > n_tx:
            raise ValueError(f"batch {spec} does not fit {params}")
        t = time.perf_counter()
        ring = rng.sample(range(n_tx), n_tx)
        bb = db.build_batch(*params)
        bb.add_token(token)
        bb.add_fee_idx(first)
        for _ in range(n_l1):
            deposit(bb, next(depositors))
        for k in range(n_l2):
            sender, receiver = ring[k], ring[(k + spec["step"]) % n_tx]
            tx = dict(fromIdx=first + sender, toIdx=first + receiver,
                      tokenID=token, amount=spec["amount"],
                      userFee=mix["user_fee"], nonce=0, onChain=0)
            accounts[sender].sign_tx(tx)
            bb.add_tx(tx)
        secs["sign"] += time.perf_counter() - t
        # the reference evaluates the batch: the input's hints are its
        # intermediate roots and fee sums, the last of which are the outputs
        t = time.perf_counter()
        bb.build()
        inp = bb.get_input()
        items.append(inp)
        builders.append(bb)
        expected.append(dict(
            new_state_root=bb.new_state_root,
            new_exit_root=bb.new_exit_root,
            new_last_idx=bb.new_last_idx,
            acc_fee_out=list(bb.fee_totals), ok=True))
        secs["build"] += time.perf_counter() - t
        work.append(workcount.rollup_work(inp, len(bb.get_inputs_str())))
    for pos in mix.get("refused_copies", ()):
        spec = mix["batches"][pos]
        n_l1 = spec.get("l1_deposits", 0)
        lane = n_l1 + rng.randrange(spec.get("l2_transfers", n_tx - n_l1))
        inp = dict(items[pos], s=list(items[pos]["s"]))
        inp["s"][lane] += 1
        items.append(inp)
        builders.append(builders[pos])
        expected.append(dict(expected[pos], ok=False))
        work.append(work[pos])
    return Load("RollupMain", items, list(range(len(items))), expected,
                work, secs, builders)


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


def _withdraw(config: dict, mix: dict, rng) -> Load:
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


def answers(load: Load, used: set) -> None:
    """Fill each used item's expected answers that the reference works out
    only to judge, once the window has closed: a RollupMain batch's
    `hash_global_inputs` (SHA-256 of its global inputs, `hash-inputs.circom`),
    a Withdraw item's `hash` a lane (SHA-256 of its public fields)."""
    for i in used:
        exp = load.expected[i]
        if load.circuit == "RollupMain" and "hash_global_inputs" not in exp:
            exp["hash_global_inputs"] = load.builders[i].get_hash_inputs()
        elif load.circuit == "Withdraw" and "hash" not in exp:
            exp["hash"] = [hash_inputs_withdraw(d) for d in load.items[i]]
