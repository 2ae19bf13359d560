"""getSingleTxInput on the port (reference test/helpers/helpers.js:45-137),
the torch copy of tests/single_tx.py: slice a built batch into per-tx
RollupTx inputs with the port's `build_chains`, `decode_tx`, `_neighbors`
and `build_tx_inputs`, so that one transaction can be driven through the
port's `rollup_tx` and asserted on its own (the reference's
rollup-tx.test.js assertTxs pattern). Everything runs on the CPU. The
battery's shape, deposits and assertTxs are here too, shared by the files
that hold tests/test_single_tx_battery.py's bodies."""

from circuits_tpu_torch.builder import float40
from circuits_tpu_torch.builder.rollup_db import RollupDB
from circuits_tpu_torch.engine.witness import pack_rollup_inputs
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.models.decode_tx import decode_tx
from circuits_tpu_torch.models.rollup_main import (_neighbors, build_chains,
                                                   build_tx_inputs)

BATTERY_CONFIG = (4, 16, 2, 2)  # (nTx, nLevels, maxL1Tx, maxFeeTx)


def batch_tx_inputs(bb):
    """Full-batch RollupTx input dict (+ chains) of a built batch."""
    n_tx, n_levels = bb.maxNTx, bb.nLevels
    max_l1, max_fee = bb.maxL1Tx, bb.totalFeeTransactions
    packed = pack_rollup_inputs(bb.get_input(), n_tx, n_levels, max_l1,
                                max_fee, device="cpu")
    chains = build_chains(packed, n_tx, max_fee)
    dec, _ = decode_tx(
        n_levels,
        chains["prev_on_chain"], packed["tx_compressed_data"],
        packed["max_num_batch"], packed["amount_f"], packed["to_eth_addr"],
        packed["to_bjj_ay"], packed["rq_tx_compressed_data_v2"],
        packed["rq_to_eth_addr"], packed["rq_to_bjj_ay"],
        packed["from_eth_addr"], packed["from_bjj_compressed"],
        packed["load_amount_f"],
        packed["global_chain_id"].expand(16, n_tx),
        packed["current_num_batch"].expand(16, n_tx),
        packed["on_chain"], packed["new_account"],
        packed["aux_from_idx"], packed["aux_to_idx"], chains["in_idx"])
    zero1 = fr.zeros((1,))
    neighbors = (*_neighbors(packed["tx_compressed_data_v2"], zero1),
                 *_neighbors(packed["to_eth_addr"], zero1),
                 *_neighbors(packed["to_bjj_ay"], zero1))
    tx_in = build_tx_inputs(packed, chains, dec, n_tx, max_fee, neighbors)
    return tx_in, chains


def get_single_tx_input(tx_in: dict, i: int) -> dict:
    """Lane i of a full-batch RollupTx input (every entry carries the
    lane axis last)."""
    return {k: v[..., i:i + 1] for k, v in tx_in.items()}


def assert_txs(bb, run_one):
    """assertTxs: every lane's single RollupTx instance must be ok and
    reproduce the im-chain state root and fee accumulators."""
    tx_in, chains = batch_tx_inputs(bb)
    for i in range(bb.maxNTx):
        single = get_single_tx_input(tx_in, i)
        out, ok = run_one(single)
        assert bool(ok[0]), f"lane {i} flagged"
        got_root = fr.unpack_int(out["new_state_root"])
        want_root = fr.unpack_int(chains["expected_state_root"][..., i:i + 1])
        assert got_root == want_root, f"lane {i} state root"
        n_fee = bb.totalFeeTransactions
        got_fees = [fr.unpack_int(out["acc_fee_out"][f]) for f in range(n_fee)]
        want_fees = [fr.unpack_int(chains["expected_acc_fee"][f, :, i:i + 1])
                     for f in range(n_fee)]
        assert got_fees == want_fees, f"lane {i} fees"


def deposit(bb, acc, token, amount):
    bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(amount),
                   tokenID=token, fromBjjCompressed=acc.bjjCompressed,
                   fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))


def new_state(*deposits):
    """newState(): one deposit batch at BATTERY_CONFIG, consolidated."""
    db = RollupDB()
    bb = db.build_batch(*BATTERY_CONFIG)
    for acc, token, amount in deposits:
        deposit(bb, acc, token, amount)
    bb.build()
    db.consolidate(bb)
    return db
