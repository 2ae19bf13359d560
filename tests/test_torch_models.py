"""The port's gadgets and lane models against the JAX package, on the
vectors of tests/test_gadgets.py, tests/test_models.py and
tests/test_fee_tx_component.py. Each case goes through both packages as
one batch (one lane per vector) and every output is compared. Exact."""

import numpy as np
import pytest

from circuits_tpu.builder import float40, tx_utils
from circuits_tpu.builder.fee_table import compute_fee as fee_oracle
from circuits_tpu.field import fr as jfr
from circuits_tpu.field.scalar import P
from circuits_tpu.models import balance_updater as jbal
from circuits_tpu.models import decode_tx as jdec
from circuits_tpu.models import fee_accumulator as jacc
from circuits_tpu.models import fee_tx as jfee
from circuits_tpu.models import rq_tx_verifier as jrq
from circuits_tpu.models import tx_states as jst
from circuits_tpu.ops import gadgets as jgad
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.models import balance_updater as bal
from circuits_tpu_torch.models import decode_tx as dec
from circuits_tpu_torch.models import fee_accumulator as acc
from circuits_tpu_torch.models import fee_tx as fee
from circuits_tpu_torch.models import rq_tx_verifier as rq
from circuits_tpu_torch.models import tx_states as st
from circuits_tpu_torch.ops import gadgets as gad

from torch_compare import assert_same, to_torch

RNG = np.random.default_rng(1234)


def rand_below(bits: int, n: int) -> list[int]:
    """n numpy-seeded integers below 2^bits."""
    words = RNG.integers(0, 2**32, size=(n, (bits + 31) // 32),
                         dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % (1 << bits)
            for row in words]


def F(vals):
    return jfr.pack_np(list(vals))


def flags(vals):
    return np.array(list(vals), dtype=np.uint32)


def both(jax_fn, port_fn, *args):
    """Run one function of each package on the same numpy arguments."""
    want = jax_fn(*args)
    got = port_fn(*[to_torch(a) if isinstance(a, np.ndarray) else a
                    for a in args])
    return got, want


# ---------------------------------------------------------------------------
# gadgets (tests/test_gadgets.py)
# ---------------------------------------------------------------------------

FLOAT_VECTORS = [6 * 0x800000000 + 123, 2 * 0x800000000 + 4545,
                 30 * 0x800000000 + 10235, 0, 0x800000000, 1,
                 31 * 0x800000000, 0x800000000 + 1, 0xFFFFFFFFFF,
                 1 << 40, P - 1]


def test_decode_float():
    got, want = both(jgad.decode_float, gad.decode_float, F(FLOAT_VECTORS))
    assert_same(got, want)
    assert [int(v) for v in fr.unpack_np(got[0])[:9]] == [
        float40.float2fix(v) for v in FLOAT_VECTORS[:9]]


FEE_CASES = {
    "all_selectors": (list(range(256)), [10**18] * 256, [1] * 256),
    "apply_fee_zero": ([176, 255], [10**18] * 2, [0, 0]),
    "overflow": ([208, 0, 255], [(1 << 126) + 5] * 3, [1, 1, 1]),
}


@pytest.mark.parametrize("case", sorted(FEE_CASES))
def test_compute_fee(case):
    sels, amounts, apply = FEE_CASES[case]
    got, want = both(jgad.compute_fee, gad.compute_fee, flags(sels),
                     F(amounts), flags(apply))
    assert_same(got, want)
    if case == "all_selectors":
        assert [int(v) for v in fr.unpack_np(got[0])] == [
            fee_oracle(10**18, s) for s in sels]


def test_mux256_rows_and_per_lane_tables():
    rows = F(rand_below(253, 256)).T.copy()        # (256, 16)
    sel = flags(RNG.permutation(256)[:40])
    assert_same(*both(jgad.mux256, gad.mux256, sel, rows))
    lanes = np.moveaxis(F([rand_below(253, 40) for _ in range(256)]), 1, 0)
    assert_same(*both(jgad.mux256, gad.mux256, sel, lanes.copy()))


def test_bits_compressed_to_ay_sign_and_fits_bits():
    bits = RNG.integers(0, 2, size=(256, 12)).astype(np.uint32)
    assert_same(*both(jgad.bits_compressed_to_ay_sign,
                      gad.bits_compressed_to_ay_sign, bits))
    vals = F([0, 1, (1 << 40) - 1, 1 << 40, (1 << 160) - 1, 1 << 160,
              P - 1] + rand_below(200, 5))
    for nbits in (32, 40, 160, 254):
        assert_same(*both(lambda a: jgad.fits_bits(a, nbits),
                          lambda a: gad.fits_bits(a, nbits), vals), nbits)


# ---------------------------------------------------------------------------
# RollupTxStates (tests/test_models.py decision table)
# ---------------------------------------------------------------------------

ANY = (1 << 160) - 1
STATE_ROWS = [
    # fromIdx toIdx toEth auxFrom auxTo amount newExit load newAcc onChain
    # fromEth ethAddr1 tokenID tokenID1 tokenID2
    (0, 0, 0, 260, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1),
    (0, 0, 0, 260, 0, 0, 0, 500, 1, 1, 0, 0, 1, 1, 1),
    (256, 0, 0, 0, 0, 0, 0, 500, 0, 1, 0, 0, 1, 1, 1),
    (0, 257, 0, 256, 0, 10, 0, 30, 1, 1, 2, 2, 3, 3, 3),
    (0, 257, 0, 256, 0, 10, 0, 30, 1, 1, 2, 2, 3, 3, 4),
    (256, 0, 0, 0, 0, 30, 0, 30, 0, 1, 2, 2, 3, 3, 3),
    (256, 0, 0, 0, 0, 30, 0, 30, 0, 1, 2, 2, 3, 4, 3),
    (256, 0, 0, 0, 0, 30, 0, 30, 0, 1, 2, 4, 3, 3, 3),
    (256, 0, 0, 0, 0, 30, 0, 0, 0, 1, 2, 2, 3, 3, 2),
    (256, 1, 0, 0, 0, 100, 1, 0, 0, 1, 0, 0, 1, 1, 1),
    (256, 257, 0, 0, 0, 100, 0, 0, 0, 0, 0, 0, 1, 1, 1),
    (256, 1, 0, 0, 0, 100, 1, 0, 0, 0, 0, 0, 1, 1, 1),
    (256, 0, 0x1234, 0, 257, 100, 0, 0, 0, 0, 0, 0, 1, 1, 1),
    (256, 0, ANY, 0, 257, 100, 0, 0, 0, 0, 0, 0, 1, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1),
    (256, 257, 0, 0, 0, 10, 0, 5, 0, 0, 0, 0, 1, 1, 1),  # L2 with a load
]
FLAG_COLS = (6, 8, 9)  # newExit, newAccount, onChain


def test_tx_states_decision_table():
    cols = list(zip(*STATE_ROWS))
    args = [flags(c) if i in FLAG_COLS else F(c) for i, c in enumerate(cols)]
    got, want = both(jst.rollup_tx_states, st.rollup_tx_states, *args)
    assert_same(got, want)
    assert not bool(got[1][-1]) and bool(got[1][:-1].all())


# ---------------------------------------------------------------------------
# BalanceUpdater, FeeAccumulator, RqTxVerifier (tests/test_models.py)
# ---------------------------------------------------------------------------

BAL_ROWS = [
    # bal1 bal2 amount load fee onChain nop nulLoad nulAmount
    (5000, 300, 1000, 0, 126, 0, 0, 0, 0),
    (100, 0, 0, 700, 200, 1, 0, 0, 0),
    (50, 0, 100, 0, 0, 0, 0, 0, 0),
    (50, 10, 100, 0, 0, 1, 0, 0, 0),
    (100, 200, 50, 50, 200, 1, 0, 1, 0),
    (100, 200, 500, 50, 200, 1, 0, 0, 1),
    (500, 10, 100, 200, 0, 1, 0, 1, 1),
    (7, 9, 0, 0, 0, 0, 1, 0, 0),
    ((1 << 192) - 1, 0, 1 << 100, 0, 255, 0, 0, 0, 0),
]


def test_balance_updater():
    cols = list(zip(*BAL_ROWS))
    args = [F(c) if i < 4 else flags(c) for i, c in enumerate(cols)]
    got, want = both(jbal.balance_updater, bal.balance_updater, *args)
    assert_same(got, want)
    assert int(fr.unpack_np(got[0]["fee2_charge"])[0]) == \
        fee_oracle(1000, 126)


FEE_VECTORS = [
    (110, 1000, list(range(101, 117)), [1001 + i for i in range(16)]),
    (103, 1000, [101, 102, 103, 103, 105, 106, 107, 108, 109, 110, 111,
                 112, 113, 114, 115, 103], [1001 + i for i in range(16)]),
    (0, 1000, [101, 102, 103, 103, 105, 106, 107, 108, 109, 110, 111, 112,
               113, 114, 115, 103], [1001 + i for i in range(16)]),
    (0, 3000, [5, 4, 3, 2, 1, 0, 6, 7, 8, 0, 0, 0, 0, 0, 0, 0],
     [1001 + i for i in range(16)]),
    (0, 1000, [0] * 16, [0] * 16),
]


def test_fee_accumulator():
    token = F([v[0] for v in FEE_VECTORS])
    fee2 = F([v[1] for v in FEE_VECTORS])
    plan = np.moveaxis(F([v[2] for v in FEE_VECTORS]), 2, 0).copy()
    acc_in = np.moveaxis(F([v[3] for v in FEE_VECTORS]), 2, 0).copy()
    got, want = both(jacc.fee_accumulator, acc.fee_accumulator, token, fee2,
                     plan, acc_in)
    assert_same(got, want)
    assert int(fr.unpack_np(got[9])[0]) == 2010


def test_rq_tx_verifier():
    n = 16
    offsets = [i % 8 for i in range(n)]
    fut = np.stack([F([11 + j] * n) for j in range(3)])
    past = np.stack([F([21 + j] * n) for j in range(4)])
    pick = {0: 0, 1: 11, 2: 12, 3: 13, 4: 24, 5: 23, 6: 22, 7: 21}
    vals = [pick[o] + (i >= 8) for i, o in enumerate(offsets)]  # 2nd half bad
    got, want = both(jrq.rq_tx_verifier, rq.rq_tx_verifier, fut, past, fut,
                     past, fut, past, F(vals), F(vals), F(vals),
                     flags(offsets))
    assert_same(got, want)
    assert got.tolist() == [True] * 8 + [False] * 8


# ---------------------------------------------------------------------------
# DecodeTx (tests/test_models.py decode vectors, one lane each)
# ---------------------------------------------------------------------------

def _decode_lanes():
    eth = 0x7E5F4552091A69125D5DFCB7B8C2659029395BDF
    bjj = 0x2AB1C5F37D0099887766554433221100FFEEDDCCBBAA99887766554433221100
    tx = dict(chainID=5, fromIdx=256, toIdx=257, tokenID=3, nonce=7,
              userFee=126, toBjjSign=True, amount=1000)
    cd = tx_utils.build_tx_compressed_data(tx)
    cd0 = tx_utils.build_tx_compressed_data(dict(chainID=0))
    cd_l1 = tx_utils.build_tx_compressed_data(
        dict(chainID=0, fromIdx=0, toIdx=257, tokenID=3, amount=0))
    cd_aux = tx_utils.build_tx_compressed_data(
        dict(chainID=5, fromIdx=256, toIdx=0, tokenID=3, nonce=7,
             userFee=126, amount=1000))
    f1000, f700 = float40.fix2float(1000), float40.fix2float(700)
    zero = dict(prev=0, cd=0, mnb=0, amount_f=0, to_eth=0, to_ay=0, rq_v2=0,
                rq_eth=0, rq_ay=0, from_eth=0, bjj=0, load_f=0, chain=0,
                cur=0, on_chain=0, new_acc=0, aux_from=0, aux_to=0, in_idx=0)
    lanes = [
        dict(cd=cd, amount_f=f1000, to_eth=0x99, to_ay=7, chain=5,
             in_idx=300),
        dict(prev=1, cd=cd0, cur=6, on_chain=1, new_acc=1, aux_from=3,
             in_idx=2),
        dict(prev=1, cd=cd0, cur=6, on_chain=1, new_acc=1, aux_from=3,
             in_idx=5),
        dict(prev=1, cd=cd0, cur=6, on_chain=1, new_acc=0, aux_from=3,
             in_idx=5),
        dict(prev=1, cd=cd0, cur=6, aux_from=3, in_idx=5),
        dict(cd=cd_aux, amount_f=f1000, chain=5, aux_to=260, in_idx=300),
        dict(prev=1, cd=cd_l1, from_eth=eth, bjj=bjj, load_f=f700,
             on_chain=1, new_acc=1, aux_from=3, in_idx=2),
        dict(cd=cd0, on_chain=1, new_acc=1, aux_from=256, in_idx=255),
        dict(cd=cd, amount_f=f1000, to_eth=0x99, to_ay=7, chain=5,
             mnb=3, cur=4, rq_v2=11, rq_eth=12, rq_ay=13, in_idx=300),
        dict(cd=cd, amount_f=1 << 40, chain=5, in_idx=300),
    ]
    return [dict(zero, **lane) for lane in lanes]


def test_decode_tx():
    lanes = _decode_lanes()

    def col(k):
        return [lane[k] for lane in lanes]

    bjj_bits = np.array([[(b >> i) & 1 for b in col("bjj")]
                         for i in range(256)], dtype=np.uint32)
    args = (flags(col("prev")), F(col("cd")), F(col("mnb")),
            F(col("amount_f")), F(col("to_eth")), F(col("to_ay")),
            F(col("rq_v2")), F(col("rq_eth")), F(col("rq_ay")),
            F(col("from_eth")), bjj_bits, F(col("load_f")), F(col("chain")),
            F(col("cur")), flags(col("on_chain")), flags(col("new_acc")),
            F(col("aux_from")), F(col("aux_to")), F(col("in_idx")))
    got, want = both(lambda *a: jdec.decode_tx(16, *a),
                     lambda *a: dec.decode_tx(16, *a), *args)
    assert_same(got, want)
    assert got[1].tolist() == [True, True, False, False, True, True, True,
                               False, False, False]


# ---------------------------------------------------------------------------
# FeeTx (tests/test_fee_tx_component.py): empty, NOP, paid and tampered slots
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fee_slots():
    from circuits_tpu.builder.account import HermezAccount
    from circuits_tpu.builder.rollup_db import RollupDB

    nlev = 16
    a1, a2 = HermezAccount(1), HermezAccount(2)
    f1, f2 = HermezAccount(3), HermezAccount(4)
    db = RollupDB()
    bb = db.build_batch(8, nlev, 6, 2)
    for a, tok, amt in [(a1, 1, 1000), (a2, 1, 1000), (a1, 2, 1000),
                        (a2, 2, 1000), (f1, 1, 0), (f2, 2, 0)]:
        bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(amt),
                       tokenID=tok, fromBjjCompressed=a.bjjCompressed,
                       fromEthAddr=a.ethAddr, toIdx=0, onChain=True))
    bb.build()
    db.consolidate(bb)
    bb2 = db.build_batch(8, nlev, 6, 2)
    for frm, to, tok, user_fee in [(256, 257, 1, 173), (258, 259, 2, 126)]:
        tx = dict(fromIdx=frm, toIdx=to, tokenID=tok, amount=50, nonce=0,
                  userFee=user_fee, onChain=0)
        a1.sign_tx(tx)
        bb2.add_tx(tx)
    bb2.add_token(1)
    bb2.add_fee_idx(260)
    bb2.add_token(2)
    bb2.add_fee_idx(261)
    bb2.build()
    g = bb2.get_input()
    old_roots = [g["imInitStateRootFee"], g["imStateRootFee"][0]]
    slots = []
    for s in range(2):
        slots.append(dict(
            root=old_roots[s], plan=g["feePlanTokens"][s],
            idx=g["feeIdxs"][s], acc=g["imFinalAccFee"][s],
            tok=g["tokenID3"][s], nonce=g["nonce3"][s], sign=g["sign3"][s],
            bal=g["balance3"][s], ay=g["ay3"][s], eth=g["ethAddr3"][s],
            sib=list(g["siblings3"][s])))
    empty = dict(root=0, plan=0, idx=0, acc=0, tok=0, nonce=0, sign=0,
                 bal=0, ay=0, eth=0, sib=[])
    nop = dict(root=rand_below(253, 1)[0], plan=5, idx=0,
               acc=rand_below(128, 1)[0], tok=9, nonce=3, sign=1,
               bal=rand_below(128, 1)[0], ay=rand_below(253, 1)[0],
               eth=rand_below(160, 1)[0], sib=rand_below(253, nlev + 1))
    tampered = dict(slots[0], plan=slots[0]["plan"] + 1)
    lanes = slots + [empty, nop, tampered]

    def col(k):
        return F([lane[k] for lane in lanes])

    sib = np.moveaxis(F([lane["sib"] + [0] * (nlev + 1 - len(lane["sib"]))
                         for lane in lanes]), 2, 0).copy()
    args = (col("root"), col("plan"), col("idx"), col("acc"), col("tok"),
            col("nonce"), flags([int(lane["sign"]) for lane in lanes]),
            col("bal"), col("ay"), col("eth"), sib)
    return args, [g["imStateRootFee"][0], bb2.get_new_state_root()]


def test_fee_tx(fee_slots):
    args, want_roots = fee_slots
    got, want = both(lambda *a: jfee.fee_tx(*a, debug=True),
                     lambda *a: fee.fee_tx(*a, debug=True), *args)
    assert_same(got, want)
    roots = [int(v) for v in fr.unpack_np(got[0])]
    assert roots[:2] == want_roots
    assert got[1].tolist() == [True, True, True, True, False]
