"""The port's own host code (`circuits_tpu_torch/{field/scalar, ops/
poseidon_constants, builder/*, utils/*}`) against the JAX package's
originals: the same inputs, made from a seed, give the same results from
both copies. All of it is integer arithmetic; every comparison is exact."""

import random

import pytest

from circuits_tpu.builder import (account as j_account, babyjub as j_babyjub,
                                  fee_table as j_fee_table,
                                  float40 as j_float40,
                                  rollup_db as j_rollup_db, smt as j_smt,
                                  state_utils as j_state_utils,
                                  tx_utils as j_tx_utils,
                                  withdraw_utils as j_withdraw_utils)
from circuits_tpu.field import scalar as j_scalar
from circuits_tpu.ops import poseidon_constants as j_pc
from circuits_tpu.utils import crypto as j_crypto, sha256_py as j_sha
from circuits_tpu_torch.builder import (account, babyjub, fee_table, float40,
                                        rollup_db, smt, state_utils, tx_utils,
                                        withdraw_utils)
from circuits_tpu_torch.field import scalar
from circuits_tpu_torch.ops import poseidon_constants as pc
from circuits_tpu_torch.utils import crypto, native, sha256_py

P = j_scalar.P
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 253) - 1, 1 << 128]
# the public circomlib / go-iden3-crypto vectors of tests/test_poseidon.py
VECTORS = {
    (1,): 18586133768512220936620570745912940619677854269274689475585506675881198879027,
    (1, 2): 7853200120776062878684798364095072458815029376092732009249414926327459813530,
    (1, 2, 3, 4): 18821383157269793795438455681495246036402687001665670618754263018637548127333,
    (1, 2, 0, 0, 0): 1018317224307729531995786483840663576608797660851238720571059489595066344487,
    (1, 2, 3, 4, 5, 6): 20400040500897583745843009878988256314335038853985262692600694741116813247201,
}


def _values(seed, n=40):
    rng = random.Random(seed)
    return EDGES + [rng.randrange(P) for _ in range(n)]


def test_scalar_constants_and_limbs():
    for name in ("P", "N_LIMBS", "LIMB_BITS", "LIMB_MASK", "R", "R2", "R3",
                 "N0", "TWO_ADICITY", "Q_ODD", "NONRESIDUE", "ROOT_OF_UNITY"):
        assert getattr(scalar, name) == getattr(j_scalar, name), name
    for v in _values(1) + [P, P + 5, (1 << 256) - 1]:
        limbs = scalar.to_limbs(v)
        assert limbs == j_scalar.to_limbs(v)
        assert scalar.from_limbs(limbs) == j_scalar.from_limbs(limbs) == v % P


def test_scalar_arithmetic_sqrt_and_inverse():
    vals = _values(2)
    for a, b in zip(vals, reversed(vals)):
        for fn in ("fadd", "fsub", "fmul"):
            assert getattr(scalar, fn)(a, b) == getattr(j_scalar, fn)(a, b)
        assert scalar.fneg(a) == j_scalar.fneg(a)
        assert scalar.fpow(a, b % 1000) == j_scalar.fpow(a, b % 1000)
        assert scalar.is_square(a) == j_scalar.is_square(a)
        root = scalar.fsqrt(a)
        assert root == j_scalar.fsqrt(a)
        if root is not None:
            assert root * root % P == a
        if a:
            inv = scalar.finv(a)
            assert inv == j_scalar.finv(a) and inv * a % P == 1


@pytest.mark.parametrize("t", [3, 4, 5, 6, 7])
def test_poseidon_constants_equal(t):
    assert pc.constants(t) == j_pc.constants(t)
    got, want = pc.optimized_constants(t), j_pc.optimized_constants(t)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    assert pc.N_ROUNDS_F == j_pc.N_ROUNDS_F
    assert pc.N_ROUNDS_P == j_pc.N_ROUNDS_P


@pytest.mark.parametrize("inp", sorted(VECTORS))
def test_poseidon_py_pure_on_circomlib_vectors(inp):
    assert pc.poseidon_py_pure(list(inp)) == VECTORS[inp]
    assert pc.poseidon_py(list(inp)) == VECTORS[inp]


def test_poseidon_py_native_equals_pure():
    """`poseidon_py` takes the C++ hash where g++ is at hand; either way it
    equals the pure one and the JAX package's."""
    rng = random.Random(3)
    for n in (1, 2, 3, 4, 5, 6):
        x = [rng.randrange(P) for _ in range(n)]
        assert pc.poseidon_py(x) == pc.poseidon_py_pure(x) == j_pc.poseidon_py(x)
    lib = native.library()
    if lib is not None:
        assert native.poseidon_native(lib, [1, 2]) == VECTORS[(1, 2)]


def test_babyjub_points_and_packing():
    rng = random.Random(4)
    for name in ("A", "D", "ORDER", "SUB_ORDER", "BASE8", "IDENTITY"):
        assert getattr(babyjub, name) == getattr(j_babyjub, name), name
    for _ in range(6):
        k = rng.randrange(babyjub.SUB_ORDER)
        pt = babyjub.mul_base8(k)
        assert pt == j_babyjub.mul_base8(k)
        assert babyjub.in_curve(pt)
        assert babyjub.mul_point(k % 1000, pt) == j_babyjub.mul_point(k % 1000, pt)
        assert babyjub.add_point(pt, babyjub.BASE8) == \
            j_babyjub.add_point(pt, j_babyjub.BASE8)
        packed = babyjub.pack_point(pt)
        assert packed == j_babyjub.pack_point(pt)
        assert babyjub.unpack_point(packed) == j_babyjub.unpack_point(packed) == pt


def test_babyjub_sign_and_verify():
    rng = random.Random(5)
    for _ in range(4):
        prv = rng.randbytes(32)
        msg = rng.randrange(P)
        assert babyjub.prv2scalar(prv) == j_babyjub.prv2scalar(prv)
        pub = babyjub.prv2pub(prv)
        assert pub == j_babyjub.prv2pub(prv)
        sig = babyjub.sign_poseidon(prv, msg)
        assert sig == j_babyjub.sign_poseidon(prv, msg)
        assert babyjub.verify_poseidon(msg, sig, pub)
        assert j_babyjub.verify_poseidon(msg, sig, pub)
        bad = (msg + 1) % P
        assert not babyjub.verify_poseidon(bad, sig, pub)
        assert not j_babyjub.verify_poseidon(bad, sig, pub)


def test_float40():
    rng = random.Random(6)
    fixes = [0, 1, 1000, float40.MANTISSA_MAX, float40.MANTISSA_MAX + 1,
             10 ** 20] + [rng.randrange(10 ** rng.randrange(1, 30))
                          for _ in range(60)]
    for fix in fixes:
        assert float40.floor_fix2float(fix) == j_float40.floor_fix2float(fix)
        assert float40.round_fix(fix) == j_float40.round_fix(fix)
        exact = float40.round_fix(fix)
        fl = float40.fix2float(exact)
        assert fl == j_float40.fix2float(exact)
        assert float40.float2fix(fl) == j_float40.float2fix(fl) == exact


def test_fee_table():
    rng = random.Random(7)
    assert fee_table.TABLE_ADJUSTED_FEE == j_fee_table.TABLE_ADJUSTED_FEE
    assert fee_table.BITS_SHIFT == j_fee_table.BITS_SHIFT
    for sel in list(range(0, 256, 5)) + [255]:
        amount = rng.randrange(1 << rng.randrange(1, 128))
        assert fee_table.compute_fee(amount, sel) == \
            j_fee_table.compute_fee(amount, sel)


def test_crypto_and_sha256():
    rng = random.Random(8)
    for n in (0, 1, 55, 64, 111, 200):
        data = rng.randbytes(n)
        assert crypto.blake512(data) == j_crypto.blake512(data)
        assert crypto.keccak256(data) == j_crypto.keccak256(data)
        bits = "".join(format(b, "08b") for b in data)
        assert sha256_py.sha256_bits_py(bits) == j_sha.sha256_bits_py(bits)
    for priv in (1, 2, rng.randrange(1, 1 << 250)):
        assert crypto.eth_address(priv) == j_crypto.eth_address(priv)


def test_smt_tree():
    rng = random.Random(9)
    trees = smt.SMT(), j_smt.SMT()
    keys = rng.sample(range(1, 1 << 16), 24)

    def both(method, *args):
        got, want = (getattr(t, method)(*args) for t in trees)
        assert got == want, method
        assert trees[0].root == trees[1].root

    for k in keys:
        both("insert", k, rng.randrange(P))
    for k in keys[:8]:
        both("update", k, rng.randrange(P))
    for k in keys[4:12]:
        both("delete", k)
    for k in keys[:14]:
        both("get", k)
    assert smt.hash0(3, 4) == j_smt.hash0(3, 4)
    assert smt.hash1(3, 4) == j_smt.hash1(3, 4)


def test_account_tx_and_state_utils():
    for seed in (1, 2, 77):
        acc, jacc = account.HermezAccount(seed), j_account.HermezAccount(seed)
        for attr in ("ethAddr", "bjjCompressed", "ax", "ay", "sign"):
            assert getattr(acc, attr) == getattr(jacc, attr), attr
        tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=150, userFee=126,
                  nonce=seed, onChain=0, chainID=3, maxNumBatch=9)
        jtx = dict(tx)
        assert tx_utils.build_tx_compressed_data(tx) == \
            j_tx_utils.build_tx_compressed_data(jtx)
        assert tx_utils.build_hash_sig(tx) == j_tx_utils.build_hash_sig(jtx)
        acc.sign_tx(tx)
        jacc.sign_tx(jtx)
        assert tx == jtx
        for n_levels in (16, 32):
            assert tx_utils.encode_l2_tx(tx, n_levels) == \
                j_tx_utils.encode_l2_tx(jtx, n_levels)
        assert account.bjj_compressed_to_bits(acc.bjjCompressed) == \
            j_account.bjj_compressed_to_bits(jacc.bjjCompressed)
    state = dict(tokenID=1, nonce=2, balance=10 ** 18, sign=1, ay=12345,
                 ethAddr="0x" + "ab" * 20)
    assert state_utils.hash_state(state) == j_state_utils.hash_state(state)
    assert state_utils.Constants.exitIdx == j_state_utils.Constants.exitIdx
    winp = dict(rootExit=123456789, ethAddr="0x" + "cd" * 20, tokenID=1,
                balance=10 ** 20, idx=300)
    assert withdraw_utils.hash_inputs_withdraw(winp) == \
        j_withdraw_utils.hash_inputs_withdraw(winp)


def _small_batches(mod_db, mod_account, mod_float40, mod_state):
    """RollupMain(8, 8, 4, 2): four L1 deposits, then a batch with an L1
    deposit on top, two L2 transfers with fees, an exit with a fee and one
    fee token."""
    cfg = (8, 8, 4, 2)
    accs = [mod_account.HermezAccount(i + 1) for i in range(4)]
    db = mod_db.RollupDB()
    dep = db.build_batch(*cfg)
    for acc in accs:
        dep.add_tx(dict(fromIdx=0, loadAmountF=mod_float40.fix2float(10_000),
                        tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                        fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))
    dep.build()
    db.consolidate(dep)
    bb = db.build_batch(*cfg)
    bb.add_token(1)
    bb.add_fee_idx(259)
    txs = [dict(fromIdx=256, toIdx=257, tokenID=1, amount=150, userFee=126,
                nonce=0, onChain=0),
           dict(fromIdx=257, toIdx=258, tokenID=1, amount=70, userFee=100,
                nonce=0, onChain=0),
           dict(fromIdx=258, toIdx=mod_state.Constants.exitIdx, tokenID=1,
                amount=100, userFee=68, nonce=0, onChain=0)]
    bb.add_tx(dict(fromIdx=256, loadAmountF=mod_float40.fix2float(500),
                   tokenID=1, fromBjjCompressed=0, fromEthAddr=accs[0].ethAddr,
                   toIdx=0, onChain=True))
    for acc, tx in zip(accs, txs):
        acc.sign_tx(tx)
        bb.add_tx(tx)
    bb.build()
    return dep, bb


@pytest.mark.parametrize("which", ["deposit", "mixed"])
def test_rollup_db_builds_the_same_batch(which):
    idx = ["deposit", "mixed"].index(which)
    got = _small_batches(rollup_db, account, float40, state_utils)[idx]
    want = _small_batches(j_rollup_db, j_account, j_float40,
                          j_state_utils)[idx]
    assert got.get_input() == want.get_input()
    assert got.get_hash_inputs() == want.get_hash_inputs()
    assert got.get_inputs_str() == want.get_inputs_str()
    for getter in ("get_old_state_root", "get_new_state_root",
                   "get_new_exit_root", "get_old_last_idx",
                   "get_new_last_idx"):
        assert getattr(got, getter)() == getattr(want, getter)(), getter
