"""tests/test_single_tx_battery.py on the port, part 1 of 4: the
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
from circuits_tpu_torch.builder.rollup_db import RollupDB
from circuits_tpu_torch.models.rollup_tx import rollup_tx

from torch_single_tx import (BATTERY_CONFIG, assert_txs, deposit)
from torch_single_tx import new_state as _state

NTX, NLEV, ML1, MFT = BATTERY_CONFIG

a1, a2, a3 = HermezAccount(1), HermezAccount(2), HermezAccount(3)


@pytest.fixture(scope="module")
def run_one():
    return partial(rollup_tx, n_levels=NLEV)


def test_nop_tx(run_one):
    """rollup-tx.test.js:56 — an empty batch: all-NOP lanes."""
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    bb.build()
    assert_txs(bb, run_one)


def test_l1_create_account(run_one):
    """:65 — createAccount (deposit 0)."""
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a1, 1, 0)
    bb.build()
    assert_txs(bb, run_one)


def test_l1_create_account_deposit(run_one):
    """:75 — createAccountDeposit."""
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a1, 1, 1000)
    bb.build()
    assert_txs(bb, run_one)


def test_l1_create_account_deposit_transfer(run_one):
    """:85 — createAccountDepositTransfer."""
    db = _state((a1, 1, 1000))
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=0, loadAmountF=500, tokenID=1,
                    fromBjjCompressed=a2.bjjCompressed,
                    fromEthAddr=a2.ethAddr, toIdx=256, amount=100,
                    userFee=0, onChain=True))
    bb2.build()
    assert_txs(bb2, run_one)


def test_l1_deposit(run_one):
    """:112 — deposit into an existing account."""
    db = _state((a1, 1, 1000))
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=500, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=0, toIdx=0,
                    amount=0, userFee=0, onChain=True))
    bb2.build()
    assert_txs(bb2, run_one)


def test_l1_deposit_transfer(run_one):
    """:139 — depositTransfer."""
    db = _state((a1, 1, 1000), (a2, 1, 2000))
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=200, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                    toIdx=257, amount=100, userFee=126, onChain=True))
    bb2.build()
    assert_txs(bb2, run_one)


def test_l1_force_transfer(run_one):
    """:167 — forceTransfer: amount != 0, amount = 0, and both."""
    db = _state((a1, 1, 1000), (a2, 1, 2000))
    tx = dict(fromIdx=256, loadAmountF=0, tokenID=1, fromBjjCompressed=0,
              fromEthAddr=a1.ethAddr, toIdx=257, amount=100, userFee=0,
              onChain=True)
    for txs in ([tx], [dict(tx, amount=0)], [tx, dict(tx, amount=0)]):
        bb = db.build_batch(NTX, NLEV, ML1, MFT)
        for t in txs:
            bb.add_tx(dict(t))
        bb.build()
        assert_txs(bb, run_one)
