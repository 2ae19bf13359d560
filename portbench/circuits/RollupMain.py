"""RollupMain(nTx, nLevels, maxL1Tx, maxFeeTx): the traffic's build from
the seed's generator and the reference's answers.

Keys of a RollupMain mix file:
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
"""

from __future__ import annotations

import time

from portbench.metrics import workcount
from portbench.reference import float40
from portbench.reference.rollup_db import RollupDB
from portbench.traffic import Account, Load


def build(config: dict, mix: dict, rng) -> Load:
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


def answer(load: Load, i: int) -> None:
    """Batch i's `hash_global_inputs`, the SHA-256 of its global inputs
    (`hash-inputs.circom`), once."""
    exp = load.expected[i]
    if "hash_global_inputs" not in exp:
        exp["hash_global_inputs"] = load.builders[i].get_hash_inputs()
