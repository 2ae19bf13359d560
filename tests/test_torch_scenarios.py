"""The bodies of tests/test_engine_scenarios.py on the port: the
reference's rq-link and maxNumBatch cases (test/rollup-main.test.js:619-696,
:858-877), the L1 edge-case battery (test/rollup-main-L1.test.js) and the
empty batch, each built with the port's builder and run end to end through
the port's `RollupEngine(..., device="cpu")` against the builder oracle
(`ok`, hashGlobalInputs and the new state root), one engine for the module.
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


@pytest.fixture(scope="module")
def funded_db():
    """Two token-1 accounts (256: a1, 257: a2), plus a token-2 account
    (258: a3 — needed by the wrong-tokenID L1 cases)."""
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a1, 1, 1000)
    deposit(bb, a2, 1, 1000)
    bb.build()
    db.consolidate(bb)
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb2, a3, 2, 1000)
    bb2.build()
    db.consolidate(bb2)
    return db


def assert_batch(engine, bb):
    out, ok = engine.run(bb.get_input())
    assert ok, "engine flagged constraint failure on a valid batch"
    assert out["hash_global_inputs"] == bb.get_hash_inputs()
    assert out["new_state_root"] == bb.get_new_state_root()


def _rq_pair():
    """tx (a1->a2) and tx2 (a2->a1) where tx2 requires tx."""
    tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=150, userFee=126,
              nonce=0, onChain=0)
    tx2 = dict(fromIdx=257, toIdx=256, tokenID=1, amount=100, userFee=126,
               nonce=0, onChain=0)
    return tx, tx2


def test_rq_linked_txs(engine, funded_db):
    # reference test/rollup-main.test.js:619-696: tx2 links tx via
    # rqOffset; correct order passes, switched order must fail, and
    # re-signing with the matching offset passes again
    db = funded_db
    tx, tx2 = _rq_pair()
    tx2["rqOffset"] = 7  # pastTx[0]: the immediately preceding lane
    tx2["rqTxCompressedDataV2"] = build_tx_compressed_data_v2(tx)
    tx2["rqToEthAddr"] = 0
    tx2["rqToBjjAy"] = 0
    a1.sign_tx(tx)
    a2.sign_tx(tx2)

    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    bb.add_token(1)
    bb.add_tx(tx)
    bb.add_tx(tx2)
    bb.build()
    assert_batch(engine, bb)

    # switched order: the linked tx is no longer in the rq window slot
    bb_bad = db.build_batch(NTX, NLEV, ML1, MFT)
    bb_bad.add_token(1)
    bb_bad.add_tx(tx2)
    bb_bad.add_tx(tx)
    bb_bad.build()  # the builder does not enforce rq links; the circuit does
    _, ok = engine.run(bb_bad.get_input())
    assert not ok

    # re-sign with rqOffset=1 (futureTx[0]) and the switched order passes
    tx2b = dict(tx2, rqOffset=1)
    a2.sign_tx(tx2b)
    bb_ok = db.build_batch(NTX, NLEV, ML1, MFT)
    bb_ok.add_token(1)
    bb_ok.add_tx(tx2b)
    bb_ok.add_tx(tx)
    bb_ok.build()
    assert_batch(engine, bb_ok)


def test_max_num_batch(engine, funded_db):
    # reference :830-877: maxNumBatch > and == currentNumBatch pass;
    # a manipulated maxNumBatch < currentNumBatch must fail
    db = funded_db

    for delta in (1, 0):
        bb = db.build_batch(NTX, NLEV, ML1, MFT)
        tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=10, userFee=0,
                  nonce=None, onChain=0,
                  maxNumBatch=db.last_batch + 1 + delta)
        tx["nonce"] = db.get_state_by_idx(256)["nonce"]
        a1.sign_tx(tx)
        bb.add_tx(tx)
        bb.build()
        assert_batch(engine, bb)

    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=10, userFee=0,
              nonce=db.get_state_by_idx(256)["nonce"], onChain=0,
              maxNumBatch=db.last_batch + 1)
    a1.sign_tx(tx)
    bb.add_tx(tx)
    bb.build()
    inp = dict(bb.get_input())
    inp["maxNumBatch"] = list(inp["maxNumBatch"])
    inp["maxNumBatch"][0] = db.last_batch  # < currentNumBatch
    _, ok = engine.run(inp)
    assert not ok


def test_l1_create_account_invalid_bjj(engine):
    # rollup-main-L1.test.js:88-122: invalid Bjj keys (garbage and
    # 0xff..ff) still create the account — L1 never verifies the key
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a1, 1, 0)
    bb.add_tx(dict(fromIdx=0, loadAmountF=0, tokenID=1,
                   fromBjjCompressed=0x12345, fromEthAddr=a1.ethAddr,
                   toIdx=0, onChain=True))
    bb.build()
    assert_batch(engine, bb)

    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=0, loadAmountF=0, tokenID=1,
                    fromBjjCompressed=(1 << 256) - 1,
                    fromEthAddr=a1.ethAddr, toIdx=0, onChain=True))
    bb2.build()
    assert_batch(engine, bb2)


def test_l1_deposit_edge_cases(engine, funded_db):
    # rollup-main-L1.test.js:125-156, 219-271: raw-float loadAmountF
    # boundaries and nullifyLoadAmount on wrong tokenID
    db = funded_db

    # 0 and 0xFFFF loadAmountF on createAccountDeposit
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    bb.add_tx(dict(fromIdx=0, loadAmountF=0, tokenID=1,
                   fromBjjCompressed=a3.bjjCompressed,
                   fromEthAddr=a3.ethAddr, toIdx=0, onChain=True))
    bb.add_tx(dict(fromIdx=0, loadAmountF=0xFFFF, tokenID=1,
                   fromBjjCompressed=a3.bjjCompressed,
                   fromEthAddr=a3.ethAddr, toIdx=0, onChain=True))
    bb.build()
    assert_batch(engine, bb)

    # deposit with wrong tokenID -> nullifyLoadAmount
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=500, tokenID=2,
                    fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                    toIdx=0, onChain=True))
    bb2.build()
    assert_batch(engine, bb2)

    # deposit from a random msg.sender (ethAddr mismatch is allowed for
    # pure deposits)
    bb3 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb3.add_tx(dict(fromIdx=256, loadAmountF=500, tokenID=1,
                    fromBjjCompressed=0,
                    fromEthAddr=0xD8AF0C5C6DEE7DCE32E59577675C026E1ADE4DE5,
                    toIdx=0, onChain=True))
    bb3.build()
    assert_batch(engine, bb3)


def test_l1_deposit_transfer_nullify(engine, funded_db):
    # rollup-main-L1.test.js:273-336: depositTransfer where amounts get
    # nullified (insufficient funds / wrong tokenID)
    db = funded_db

    # amountF = 0xFFFF with insufficient funds -> nullifyAmount, and the
    # load still applies
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    bb.add_tx(dict(fromIdx=256, loadAmountF=500, tokenID=1,
                   fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                   toIdx=257, amountF=0xFFFF, onChain=True))
    bb.build()
    assert_batch(engine, bb)

    # wrong tokenID on the receiver -> nullifyAmount (258 holds token 2)
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=200, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                    toIdx=258, amountF=100, onChain=True))
    bb2.build()
    assert_batch(engine, bb2)

    # fromEthAddr does not match fromIdx owner -> nullifyAmount
    bb3 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb3.add_tx(dict(fromIdx=256, loadAmountF=0, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a3.ethAddr,
                    toIdx=257, amount=500, onChain=True))
    bb3.build()
    assert_batch(engine, bb3)


def test_l1_force_exit_edge_cases(engine, funded_db):
    # rollup-main-L1.test.js:419-488: forceExit with wrong tokenID
    # (nullified -> 0-amount exit leaf), amount=0, and a mixed pair
    db = funded_db

    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    bb.add_tx(dict(fromIdx=256, loadAmountF=0, tokenID=2,
                   fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                   toIdx=Constants.exitIdx, amount=100, onChain=True))
    bb.build()
    assert_batch(engine, bb)

    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_tx(dict(fromIdx=256, loadAmountF=0, tokenID=1,
                    fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                    toIdx=Constants.exitIdx, amount=0, onChain=True))
    bb2.build()
    assert_batch(engine, bb2)

    bb3 = db.build_batch(NTX, NLEV, ML1, MFT)
    for amount in (100, 0):
        bb3.add_tx(dict(fromIdx=256, loadAmountF=0, tokenID=1,
                        fromBjjCompressed=0, fromEthAddr=a1.ethAddr,
                        toIdx=Constants.exitIdx, amount=amount,
                        onChain=True))
    bb3.build()
    assert_batch(engine, bb3)


def test_empty_batch_hash_inputs(engine):
    # reference test/hash-inputs.test.js:42-82: the all-NOP batch's
    # hashGlobalInputs must match the oracle
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    bb.build()
    assert_batch(engine, bb)
