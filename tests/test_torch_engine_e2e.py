"""The bodies of tests/test_engine_e2e.py on the port: batch builder ->
packed inputs -> the port's RollupMain witness on the CPU == the builder
oracle (the assertBatch equivalent, reference test/helpers/helpers.js:147),
a tampered input that must fail, and a withdrawal through the port's
`WithdrawEngine` against the builder's hash, tampered balance refused.
(3, 16, 2, 2), the JAX file's parametrization."""

import pytest

from circuits_tpu_torch.builder.rollup_db import RollupDB
from circuits_tpu_torch.builder.account import HermezAccount
from circuits_tpu_torch.builder import float40
from circuits_tpu_torch.builder.state_utils import Constants
from circuits_tpu_torch.engine.witness import RollupEngine, WithdrawEngine

NTX, NLEV, ML1, MFT = 3, 16, 2, 2

a1 = HermezAccount(1)
a2 = HermezAccount(2)


def deposit(bb, acc, token, amount):
    bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(amount),
                   tokenID=token, fromBjjCompressed=acc.bjjCompressed,
                   fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))


@pytest.fixture(scope="module")
def engine():
    return RollupEngine(NTX, NLEV, ML1, MFT, device="cpu")


@pytest.fixture(scope="module")
def funded_db():
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    deposit(bb, a1, 1, 1000)
    deposit(bb, a2, 1, 1000)
    bb.build()
    db.consolidate(bb)
    return db, bb


def assert_batch(engine, bb):
    out, ok = engine.run(bb.get_input())
    assert ok, "engine flagged constraint failure on a valid batch"
    assert out["hash_global_inputs"] == bb.get_hash_inputs()
    assert out["new_state_root"] == bb.get_new_state_root()
    assert out["new_exit_root"] == bb.get_new_exit_root()
    assert out["new_last_idx"] == bb.get_new_last_idx()


def test_deposit_batch(engine, funded_db):
    _, bb = funded_db
    assert_batch(engine, bb)


def test_l2_transfer_exit_and_fees(engine, funded_db):
    db, _ = funded_db
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    bb2.add_token(1)
    bb2.add_fee_idx(256)
    tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=150, userFee=126,
              nonce=0, onChain=0)
    a1.sign_tx(tx)
    tx2 = dict(fromIdx=257, toIdx=Constants.exitIdx, tokenID=1,
               amount=100, userFee=68, nonce=0, onChain=0)
    a2.sign_tx(tx2)
    bb2.add_tx(tx)
    bb2.add_tx(tx2)
    bb2.build()
    assert_batch(engine, bb2)


def test_manipulated_input_fails(engine, funded_db):
    # the negative-path contract: tampered witness inputs must flag
    # (test/rollup-main.test.js:866-877 expects "Constraint doesn't match")
    db, _ = funded_db
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=10, userFee=0,
              nonce=0, onChain=0)
    a1.sign_tx(tx)
    bb2.add_tx(tx)
    bb2.build()
    inp = {k: (list(v) if isinstance(v, list) else v)
           for k, v in bb2.get_input().items()}
    inp["balance1"] = list(inp["balance1"])
    inp["balance1"][0] += 7  # sender balance no longer matches the tree
    _, ok = engine.run(inp)
    assert not ok


def test_withdraw_engine(funded_db):
    db, _ = funded_db
    bb2 = db.build_batch(NTX, NLEV, ML1, MFT)
    tx = dict(fromIdx=256, toIdx=Constants.exitIdx, tokenID=1, amount=400,
              userFee=0, nonce=0, onChain=0)
    a1.sign_tx(tx)
    bb2.add_tx(tx)
    bb2.build()
    db.consolidate(bb2)

    info = db.get_exit_tree_info(256, db.last_batch)
    st = info["state"]
    winp = dict(rootExit=info["root"], ethAddr=st["ethAddr"],
                tokenID=st["tokenID"], balance=st["balance"], idx=256,
                sign=st["sign"], ay=st["ay"],
                siblingsState=info["siblings"])
    eng = WithdrawEngine(NLEV, device="cpu")
    hashes, ok = eng.run([winp])
    assert bool(ok[0])
    # oracle: withdrawUtils.hashInputsWithdraw equivalent
    from circuits_tpu_torch.builder.withdraw_utils import hash_inputs_withdraw

    assert hashes[0] == hash_inputs_withdraw(
        dict(rootExit=info["root"], ethAddr=st["ethAddr"],
             tokenID=st["tokenID"], balance=st["balance"], idx=256))

    # tampered balance must fail (test/withdraw.test.js:160-171)
    winp_bad = dict(winp, balance=st["balance"] + 1)
    _, ok = eng.run([winp_bad])
    assert not bool(ok[0])
