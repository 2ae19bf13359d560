"""The bodies of tests/test_engine_scenarios2.py on the port, with the
port's builder and `RollupEngine(..., device="cpu")`, one engine for the
module, against the builder oracle:

  * L2 transfer & exit with 0 amount (+ mixed 0/non-0 batches)
        reference test/rollup-main.test.js:337-478
  * rq-offset linked transferToEthAddr / transferToBjj batches
        reference test/rollup-main.test.js:698-817
  * L1 createAccountDepositTransfer edge battery
        reference test/rollup-main-L1.test.js:158-217
  * L1 forceTransfer edge battery
        reference test/rollup-main-L1.test.js:338-417

(3, 16, 2, 2), the JAX file's parametrization."""

import pytest

from circuits_tpu_torch.builder.rollup_db import RollupDB
from circuits_tpu_torch.builder.account import HermezAccount
from circuits_tpu_torch.builder import float40
from circuits_tpu_torch.builder.state_utils import Constants
from circuits_tpu_torch.builder.tx_utils import build_tx_compressed_data_v2
from circuits_tpu_torch.engine.witness import RollupEngine

NTX, NLEV, ML1, MFT = 3, 16, 2, 2

a1 = HermezAccount(1)
a2 = HermezAccount(2)
a3 = HermezAccount(3)


def deposit(bb, acc, token, amount):
    bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(amount),
                   tokenID=token, fromBjjCompressed=acc.bjjCompressed,
                   fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))


@pytest.fixture(scope="module")
def engine():
    return RollupEngine(NTX, NLEV, ML1, MFT, device="cpu")


def assert_batch(engine, bb):
    out, ok = engine.run(bb.get_input())
    assert ok, "engine flagged constraint failure on a valid batch"
    assert out["hash_global_inputs"] == bb.get_hash_inputs()
    assert out["new_state_root"] == bb.get_new_state_root()


def assert_balances(db, expected: dict):
    for idx, bal in expected.items():
        assert db.get_state_by_idx(idx)["balance"] == bal, f"idx {idx}"


def _two_token1_accounts():
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a1, 1, 1000)
    deposit(bb, a2, 1, 1000)
    bb.build()
    db.consolidate(bb)
    return db


def test_l2_zero_amount_transfer_and_exit(engine):
    """rollup-main.test.js:337-478: L2 transfer / exit with amount 0,
    then mixed non-0/0 batches, with exact balance assertions."""
    db = _two_token1_accounts()

    # transfer with amount = 0
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=0, userFee=0,
              nonce=0, onChain=0)
    a1.sign_tx(tx)
    bb2.add_tx(tx)
    bb2.build()
    db.consolidate(bb2)
    assert_batch(engine, bb2)
    assert_balances(db, {256: 1000, 257: 1000})

    # exit with amount = 0
    bb3 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx2 = dict(fromIdx=257, toIdx=Constants.exitIdx, tokenID=1, amount=0,
               userFee=0, nonce=0, onChain=0)
    a2.sign_tx(tx2)
    bb3.add_tx(tx2)
    bb3.build()
    db.consolidate(bb3)
    assert_batch(engine, bb3)
    assert_balances(db, {256: 1000, 257: 1000})

    # two exits in one batch: amount != 0 then amount = 0
    bb4 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx3 = dict(fromIdx=257, toIdx=Constants.exitIdx, tokenID=1,
               amount=500, userFee=0, nonce=1, onChain=0)
    tx4 = dict(fromIdx=257, toIdx=Constants.exitIdx, tokenID=1,
               amount=0, userFee=0, nonce=2, onChain=0)
    a2.sign_tx(tx3)
    a2.sign_tx(tx4)
    bb4.add_tx(tx3)
    bb4.add_tx(tx4)
    bb4.build()
    db.consolidate(bb4)
    assert_batch(engine, bb4)
    assert_balances(db, {256: 1000, 257: 500})

    # two transfers in one batch: amount != 0 then amount = 0
    bb5 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx5 = dict(fromIdx=256, toIdx=257, tokenID=1, amount=500, userFee=0,
               nonce=1, onChain=0)
    tx6 = dict(fromIdx=256, toIdx=257, tokenID=1, amount=0, userFee=0,
               nonce=2, onChain=0)
    a1.sign_tx(tx5)
    a1.sign_tx(tx6)
    bb5.add_tx(tx5)
    bb5.add_tx(tx6)
    bb5.build()
    db.consolidate(bb5)
    assert_batch(engine, bb5)
    assert_balances(db, {256: 500, 257: 1000})


def test_transfer_to_eth_addr_with_rq(engine):
    """rollup-main.test.js:698-751: tx2 atomically requires the
    transferToEthAddr tx via rqOffset=7 (pastTx[0])."""
    db = _two_token1_accounts()
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx = dict(fromIdx=256, toIdx=Constants.nullIdx, toEthAddr=a1.ethAddr,
              tokenID=1, amount=150, userFee=126, nonce=0, onChain=0)
    tx2 = dict(fromIdx=257, toIdx=256, tokenID=1, amount=100,
               userFee=126, nonce=0, onChain=0,
               rqOffset=7, rqTxCompressedDataV2=build_tx_compressed_data_v2(tx),
               rqToEthAddr=tx["toEthAddr"], rqToBjjAy=0)
    a1.sign_tx(tx)
    a2.sign_tx(tx2)
    bb2.add_tx(tx)
    bb2.add_tx(tx2)
    bb2.add_token(1)
    bb2.build()
    assert_batch(engine, bb2)


def test_transfer_to_bjj_with_rq(engine):
    """rollup-main.test.js:753-817: coordinator-created Bjj account
    (fromEthAddr = 0xff..ff), then a transferToBjj linked by rqOffset."""
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a1, 1, 1000)
    bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(1000),
                   tokenID=1, fromBjjCompressed=a2.bjjCompressed,
                   fromEthAddr=Constants.nullEthAddr,
                   toIdx=Constants.nullIdx, onChain=True))
    bb.build()
    db.consolidate(bb)

    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx = dict(fromIdx=256, toIdx=Constants.nullIdx,
              toEthAddr=Constants.nullEthAddr, toBjjAy=a2.ay,
              toBjjSign=a2.sign, tokenID=1, amount=150, userFee=126,
              nonce=0, onChain=0)
    tx2 = dict(fromIdx=257, toIdx=256, tokenID=1, amount=100,
               userFee=126, nonce=0, onChain=0,
               rqOffset=7, rqTxCompressedDataV2=build_tx_compressed_data_v2(tx),
               rqToEthAddr=tx["toEthAddr"], rqToBjjAy=tx["toBjjAy"])
    a1.sign_tx(tx)
    a2.sign_tx(tx2)
    bb2.add_tx(tx)
    bb2.add_tx(tx2)
    bb2.add_token(1)
    bb2.build()
    assert_batch(engine, bb2)


def test_l1_create_account_deposit_transfer_edges(engine):
    """rollup-main-L1.test.js:158-217: createAccountDepositTransfer with
    amountF 0 / 0xFFFF (nullified on insufficient funds), full-loadAmount
    transfer, and wrong-tokenID receiver (nullifyAmount)."""
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a1, 1, 1000)
    deposit(bb, a2, 2, 1000)
    bb.build()
    db.consolidate(bb)

    base = dict(fromIdx=0, loadAmountF=500, tokenID=1,
                fromBjjCompressed=a3.bjjCompressed,
                fromEthAddr=a3.ethAddr, toIdx=256, userFee=0,
                onChain=True)

    # 0 and 0xFFFF amountF (0xFFFF -> not enough funds -> nullifyAmount)
    bb1 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb1.add_tx(dict(base, amountF=0))
    bb1.add_tx(dict(base, amountF=0xFFFF))
    bb1.build()
    assert_batch(engine, bb1)

    # 0xFFFF amountF with matching 0xFFFF loadAmountF: transfers all
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(base, loadAmountF=0xFFFF, amountF=0xFFFF))
    bb2.build()
    assert_batch(engine, bb2)

    # wrong tokenID receiver -> nullifyAmount
    bb3 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb3.add_tx(dict(base, toIdx=257, amountF=100))
    bb3.build()
    assert_batch(engine, bb3)


def test_l1_force_transfer_edges(engine):
    """rollup-main-L1.test.js:338-417: forceTransfer nullification edge
    cases + 0-amount + mixed batch."""
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a1, 1, 1000)
    deposit(bb, a2, 2, 1000)
    bb.build()
    db.consolidate(bb)
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a3, 1, 1000)
    bb.build()
    db.consolidate(bb)
    # accounts: 256 = a1 (token 1), 257 = a2 (token 2), 258 = a3 (token 1)

    base = dict(fromIdx=256, loadAmountF=0, tokenID=1, fromBjjCompressed=0,
                fromEthAddr=a1.ethAddr, toIdx=258, amount=500, userFee=0,
                onChain=True)

    # receiver tokenID mismatch -> nullifyAmount
    bb1 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb1.add_tx(dict(base, toIdx=257))
    bb1.build()
    assert_batch(engine, bb1)

    # fromIdx does not match tokenID -> nullifyAmount
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(base, toIdx=257, tokenID=2))
    bb2.build()
    assert_batch(engine, bb2)

    # fromEthAddr does not match fromIdx's ethAddr -> nullifyAmount
    bb3 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb3.add_tx(dict(base, fromEthAddr=a3.ethAddr))
    bb3.build()
    assert_batch(engine, bb3)

    # transfer 0 amount
    bb4 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb4.add_tx(dict(base, amount=0))
    bb4.build()
    assert_batch(engine, bb4)

    # 2 forceTransfers: amount != 0 then amount = 0
    bb5 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb5.add_tx(dict(base))
    bb5.add_tx(dict(base, amount=0))
    bb5.build()
    assert_batch(engine, bb5)


def test_l1_force_exit_eth_addr_mismatch(engine):
    """rollup-main-L1.test.js:455-465: forceExit whose fromEthAddr does
    not match the leaf's ethAddr — amount nullified, but the exit leaf
    is still created with 0 balance."""
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a1, 1, 1000)
    deposit(bb, a2, 2, 1000)
    bb.build()
    db.consolidate(bb)

    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=0, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a2.ethAddr,
                    toIdx=Constants.exitIdx, amount=100, userFee=0,
                    onChain=True))
    bb2.build()
    assert_batch(engine, bb2)
    # amount nullified: sender balance untouched, 0-balance exit leaf
    assert bb2.accounts[256].balance == 1000
    assert bb2.exit_accounts[256].balance == 0
