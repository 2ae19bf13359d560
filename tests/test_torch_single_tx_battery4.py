"""tests/test_single_tx_battery.py on the port, part 4 of 4: the
reference's rollup-tx.test.js battery (line anchors in each docstring). The
assertTxs pattern: build a real batch with the port's builder, slice each
lane into ONE RollupTx instance input (tests/torch_single_tx.py, the
getSingleTxInput equivalent), evaluate it with the port's `rollup_tx` on
the CPU, and assert per-lane ok, state root and accumulated fees against
the builder's im chains. The battery is split in four files because one
single-lane instance takes seconds on the CPU."""

from functools import partial

import pytest

from circuits_tpu_torch.builder.account import HermezAccount
from circuits_tpu_torch.builder.state_utils import Constants
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.models.rollup_tx import rollup_tx

from torch_single_tx import (BATTERY_CONFIG, assert_txs, deposit,
                             batch_tx_inputs, get_single_tx_input)
from torch_single_tx import new_state as _state

NTX, NLEV, ML1, MFT = BATTERY_CONFIG

a1, a2, a3 = HermezAccount(1), HermezAccount(2), HermezAccount(3)


@pytest.fixture(scope="module")
def run_one():
    return partial(rollup_tx, n_levels=NLEV)


def test_nullifiers_l1_deposit_transfer_part3(run_one):
    """:632 — sender tokenID mismatch nullifies loadAmount + amount."""
    db = _state((a1, 1, 1000), (a2, 2, 2000))
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=500, tokenID=2,
                    fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                    toIdx=257, amount=100, userFee=126, onChain=True))
    bb2.build()
    assert_txs(bb2, run_one)


def test_nullifiers_l1_force_transfer(run_one):
    """:662 — the three forceTransfer nullifier cases."""
    db = _state((a1, 1, 1000), (a2, 1, 2000))

    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=0, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a2.ethAddr,
                    toIdx=257, amount=100, userFee=0, onChain=True))
    bb2.build()

    bb3 = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb3, a3, 2, 3000)
    bb3.add_tx(dict(fromIdx=258, loadAmountF=0, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a3.ethAddr,
                    toIdx=257, amount=100, userFee=0, onChain=True))
    bb3.build()

    bb4 = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb4, a3, 2, 3000)
    bb4.add_tx(dict(fromIdx=256, loadAmountF=0, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                    toIdx=258, amount=100, userFee=0, onChain=True))
    bb4.build()

    for bb in (bb2, bb3, bb4):
        assert_txs(bb, run_one)


def test_underflow_l1_force_transfer(run_one):
    """:730 — L1 underflow degrades to a nullified amount."""
    db = _state((a1, 1, 1000), (a2, 1, 2000))
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=0, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                    toIdx=257, amount=1100, userFee=0, onChain=True))
    bb2.build()
    assert_txs(bb2, run_one)


def test_nullifiers_l1_force_exit(run_one):
    """:759 — nullified exits still insert 0-balance exit leaves."""
    db = _state((a1, 1, 1000), (a2, 2, 1000))
    ex = dict(fromIdx=256, loadAmountF=0, tokenID=1, fromBjjCompressed=0,
              fromEthAddr=a1.ethAddr, toIdx=Constants.exitIdx,
              amount=100, userFee=0, onChain=True)

    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(ex, fromEthAddr=a2.ethAddr))  # ethAddr mismatch
    bb2.add_tx(dict(ex))                           # real exit
    bb2.build()

    bb3 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb3.add_tx(dict(ex, tokenID=2))                # tokenID mismatch
    bb3.add_tx(dict(ex))
    bb3.build()

    bb4 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb4.add_tx(dict(ex))
    bb4.add_tx(dict(ex, fromIdx=257))              # wrong-token leaf
    bb4.build()

    for bb in (bb2, bb3, bb4):
        assert_txs(bb, run_one)


def test_l1_error_force_exit(run_one):
    """:872 — tampering tokenID1 of a single-instance input must flag a
    constraint failure (the "Constraint doesn't match" path)."""
    db = _state((a1, 1, 1000))
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=0, tokenID=2,
                    fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                    toIdx=Constants.exitIdx, amount=100, userFee=0,
                    onChain=True))
    bb2.add_tx(dict(fromIdx=256, loadAmountF=0, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                    toIdx=Constants.exitIdx, amount=100, userFee=0,
                    onChain=True))
    bb2.build()
    tx_in, _ = batch_tx_inputs(bb2)
    single = get_single_tx_input(tx_in, 1)
    assert bool(run_one(single)[1][0]), "the lane as built must pass"
    single = dict(single, token_id1=fr.pack([2]))
    _, ok = run_one(single)
    assert not bool(ok[0])
