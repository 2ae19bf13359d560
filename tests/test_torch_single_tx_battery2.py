"""tests/test_single_tx_battery.py on the port, part 2 of 4: the
reference's rollup-tx.test.js battery (line anchors in each docstring). The
assertTxs pattern: build a real batch with the port's builder, slice each
lane into ONE RollupTx instance input (tests/torch_single_tx.py, the
getSingleTxInput equivalent), evaluate it with the port's `rollup_tx` on
the CPU, and assert per-lane ok, state root and accumulated fees against
the builder's im chains. The battery is split in four files because one
single-lane instance takes seconds on the CPU."""

from functools import partial

import pytest

from circuits_tpu_torch.builder import float40
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


def test_l1_force_exit(run_one):
    """:216 — forceExit: single, double, 0-amount, mixed."""
    db = _state((a1, 1, 1000), (a2, 1, 2000))
    tx = dict(fromIdx=256, loadAmountF=0, tokenID=1, fromBjjCompressed=0,
              fromEthAddr=a1.ethAddr, toIdx=Constants.exitIdx,
              amount=100, userFee=0, onChain=True)
    for txs in ([tx], [tx, tx], [dict(tx, amount=0)],
                [tx, dict(tx, amount=0)]):
        bb = db.build_batch(NTX, NLEV, ML1, MFT)
        for t in txs:
            bb.add_tx(dict(t))
        bb.build()
        assert_txs(bb, run_one)


def test_l2_transfer(run_one):
    """:275 — transfer: amount != 0, amount = 0, and both."""
    db = _state((a1, 1, 1000), (a2, 1, 2000))
    base = dict(fromIdx=256, toIdx=257, tokenID=1, amount=100,
                userFee=184, nonce=0, onChain=0)

    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx = dict(base)
    a1.sign_tx(tx)
    bb2.add_tx(tx)
    bb2.add_token(1)
    bb2.build()
    assert_txs(bb2, run_one)

    bb3 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx2 = dict(base, amount=0)
    a1.sign_tx(tx2)
    bb3.add_tx(tx2)
    bb3.add_token(1)
    bb3.build()
    assert_txs(bb3, run_one)

    bb4 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx3 = dict(base)
    tx4 = dict(base, amount=0, nonce=1)
    a1.sign_tx(tx3)
    a1.sign_tx(tx4)
    bb4.add_tx(tx3)
    bb4.add_tx(tx4)
    bb4.add_token(1)
    bb4.build()
    assert_txs(bb4, run_one)


def test_l2_transfer_to_eth_addr(run_one):
    """:414 — transferToEthAddr."""
    db = _state((a1, 1, 1000), (a2, 1, 2000))
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx = dict(fromIdx=256, toIdx=Constants.nullIdx, toEthAddr=a2.ethAddr,
              tokenID=1, amount=50, nonce=0, userFee=126, onChain=0)
    a1.sign_tx(tx)
    bb2.add_tx(tx)
    bb2.build()
    assert_txs(bb2, run_one)


def test_l2_transfer_to_bjj(run_one):
    """:443 — transferToBjj via a coordinator-created Bjj account."""
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a1, 1, 1000)
    bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(1000),
                   tokenID=1, fromBjjCompressed=a2.bjjCompressed,
                   fromEthAddr=Constants.nullEthAddr, toIdx=0,
                   onChain=True))
    bb.build()
    db.consolidate(bb)
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx = dict(fromIdx=256, toIdx=Constants.nullIdx,
              toEthAddr=Constants.nullEthAddr, toBjjAy=a2.ay,
              toBjjSign=a2.sign, tokenID=1, amount=50, nonce=0,
              userFee=126, onChain=0)
    a1.sign_tx(tx)
    bb2.add_tx(tx)
    bb2.build()
    assert_txs(bb2, run_one)
