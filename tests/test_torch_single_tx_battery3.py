"""tests/test_single_tx_battery.py on the port, part 3 of 4: the
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
from circuits_tpu_torch.builder.state_utils import Constants
from circuits_tpu_torch.models.rollup_tx import rollup_tx

from torch_single_tx import (BATTERY_CONFIG, assert_txs, deposit)
from torch_single_tx import new_state as _state

NTX, NLEV, ML1, MFT = BATTERY_CONFIG

a1, a2, a3 = HermezAccount(1), HermezAccount(2), HermezAccount(3)


@pytest.fixture(scope="module")
def run_one():
    return partial(rollup_tx, n_levels=NLEV)


def test_l2_exit(run_one):
    """:339 — exit: single, double, 0-amount, mixed."""
    db = _state((a1, 1, 1000), (a2, 1, 2000))
    base = dict(fromIdx=256, toIdx=Constants.exitIdx, tokenID=1,
                amount=100, userFee=184, nonce=0, onChain=0)

    for spec in ([dict(base)],
                 [dict(base), dict(base, nonce=1)],
                 [dict(base, amount=0)],
                 [dict(base, amount=0), dict(base, amount=0, nonce=1)]):
        bb = db.build_batch(NTX, NLEV, ML1, MFT)
        for t in spec:
            a1.sign_tx(t)
            bb.add_tx(t)
        bb.build()
        assert_txs(bb, run_one)


def test_l1_create_account_deposit_invalid_bjj(run_one):
    """:483 — garbage Bjj key still creates the account on L1."""
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    bb.add_tx(dict(fromIdx=0, loadAmountF=1000, tokenID=1,
                   fromBjjCompressed=0x123456, fromEthAddr=0x123456789,
                   toIdx=0, onChain=True))
    bb.build()
    assert_txs(bb, run_one)


def test_nullifiers_l1_create_account_deposit_transfer(run_one):
    """:501 — wrong tokenID receiver -> nullifyAmount."""
    db = _state((a1, 1, 1000))
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=0, loadAmountF=500, tokenID=2,
                    fromBjjCompressed=a2.bjjCompressed,
                    fromEthAddr=a2.ethAddr, toIdx=256, amount=100,
                    userFee=0, onChain=True))
    bb2.build()
    assert_txs(bb2, run_one)


def test_nullifiers_l1_deposit(run_one):
    """:528 — deposit with wrong tokenID -> nullifyLoadAmount."""
    db = _state((a1, 1, 1000))
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=500, tokenID=2,
                    fromBjjCompressed=0, fromEthAddr=0, toIdx=0,
                    amount=0, userFee=0, onChain=True))
    bb2.build()
    assert_txs(bb2, run_one)


def test_nullifiers_l1_deposit_transfer_part1(run_one):
    """:555 — ethAddr mismatch nullifies amount; wrong tokenID nullifies
    both loadAmount and amount."""
    db = _state((a1, 1, 1000), (a2, 1, 2000))
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=500, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a2.ethAddr,
                    toIdx=257, amount=100, userFee=126, onChain=True))
    bb2.add_tx(dict(fromIdx=256, loadAmountF=500, tokenID=2,
                    fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                    toIdx=257, amount=100, userFee=126, onChain=True))
    bb2.build()
    assert_txs(bb2, run_one)


def test_nullifiers_l1_deposit_transfer_part2(run_one):
    """:600 — receiver tokenID mismatch (same-batch created account)."""
    db = _state((a1, 1, 1000), (a2, 1, 2000))
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb2, a3, 2, 3000)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=500, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a2.ethAddr,
                    toIdx=258, amount=100, userFee=126, onChain=True))
    bb2.build()
    assert_txs(bb2, run_one)
