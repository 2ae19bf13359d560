"""tests/test_single_tx.py on the port: the assertTxs equivalent
(reference test/rollup-tx.test.js + helpers) drives ONE RollupTx instance
of the port per transaction of a built batch, on the CPU, and asserts its
ok, state root and accumulated fees against the builder's im chains."""

from functools import partial

from circuits_tpu_torch.builder import float40
from circuits_tpu_torch.builder.account import HermezAccount
from circuits_tpu_torch.builder.rollup_db import RollupDB
from circuits_tpu_torch.builder.state_utils import Constants
from circuits_tpu_torch.models.rollup_tx import rollup_tx

from torch_single_tx import BATTERY_CONFIG, assert_txs

NTX, NLEV, ML1, MFT = BATTERY_CONFIG

a1, a2 = HermezAccount(1), HermezAccount(2)


def _built_batch():
    db = RollupDB()
    bb = db.build_batch(NTX, NLEV, ML1, MFT)
    for acc, amt in [(a1, 1000), (a2, 1000)]:
        bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(amt),
                       tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                       fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))
    bb.build()
    db.consolidate(bb)
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
    return bb2


def test_single_tx_instances_match_im_chain():
    assert_txs(_built_batch(), partial(rollup_tx, n_levels=NLEV))
