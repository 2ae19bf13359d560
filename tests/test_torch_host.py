"""The port's own host code (`circuits_tpu_torch/{field/scalar, ops/
poseidon_constants, builder/*, utils/*, r1cs/constraints,
r1cs/witness_check}`) against the JAX package's originals: the same inputs, made from a seed, give the same results from
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
from circuits_tpu.r1cs import (constraints as j_constraints,
                               witness_check as j_wc)
from circuits_tpu.utils import crypto as j_crypto, sha256_py as j_sha
from circuits_tpu_torch.builder import (account, babyjub, fee_table, float40,
                                        rollup_db, smt, state_utils, tx_utils,
                                        withdraw_utils)
from circuits_tpu_torch.field import scalar
from circuits_tpu_torch.ops import poseidon_constants as pc
from circuits_tpu_torch.r1cs import constraints, witness_check as wc
from circuits_tpu_torch.scripts import withdraw_cases
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


# ---------------------------------------------------------------------------
# r1cs/constraints.py and r1cs/witness_check.py
# ---------------------------------------------------------------------------

CONSTRAINT_ARGS = {
    "decode_tx": [(8,), (16,), (32,)],
    "fee_tx": [(8,), (32,)],
    "rollup_tx": [(16, 2), (32, 64)],
    "bits_l1_tx_full_data": [()],
    "bits_l1l2_tx_data": [(16,), (32,)],
    "hash_inputs": [(3, 16, 2, 2), (2048, 32, 256, 64)],
    "im_signals": [(3, 2), (2048, 64)],
    "total_constraints": [(3, 16, 2, 2), (376, 32, 128, 64),
                          (2048, 32, 256, 64)],
}


@pytest.mark.parametrize("fn", sorted(CONSTRAINT_ARGS))
def test_constraint_model(fn):
    assert sorted(CONSTRAINT_ARGS) == sorted(
        k for k, v in vars(j_constraints).items()
        if callable(v) and not k.startswith("_") and k != "annotations")
    for args in CONSTRAINT_ARGS[fn]:
        got = getattr(constraints, fn)(*args)
        assert got == getattr(j_constraints, fn)(*args) and got > 0


def test_witness_check_scalar_helpers():
    rng = random.Random(10)
    assert (wc.BJJ_A, wc.BJJ_D, wc.MAX_NLEVELS) == \
        (j_wc.BJJ_A, j_wc.BJJ_D, j_wc.MAX_NLEVELS)
    for _ in range(40):
        f = rng.randrange(1 << 40)
        assert wc._decode_float(f) == j_wc._decode_float(f)
        sel, amount = rng.randrange(256), rng.randrange(1 << rng.randrange(1, 192))
        for apply_fee in (False, True):
            assert wc._compute_fee(sel, amount, apply_fee) == \
                j_wc._compute_fee(sel, amount, apply_fee)
        st = (rng.randrange(1 << 32), rng.randrange(1 << 40), rng.randrange(2),
              rng.randrange(1 << 192), rng.randrange(P), rng.randrange(1 << 160))
        assert wc._hash_state(*st) == j_wc._hash_state(*st)
        assert wc._be(st[3], 192) == j_wc._be(st[3], 192)
    assert wc._hash_state(1, 2, 1, 10 ** 18, 12345, 7) == \
        state_utils.hash_state(dict(tokenID=1, nonce=2, sign=1,
                                    balance=10 ** 18, ay=12345, ethAddr=7))


def test_witness_check_curve_helpers():
    rng = random.Random(11)
    for i in range(4):
        prv = rng.randbytes(32)
        pub = babyjub.prv2pub(prv)
        msg = rng.randrange(P)
        sig = babyjub.sign_poseidon(prv, msg)
        sign = int(pub[0] > P // 2)
        got = wc._ay_sign_to_ax(pub[1], sign)
        assert got == j_wc._ay_sign_to_ax(pub[1], sign) == (pub[0], True)
        args = (pub[0], pub[1], sig["S"], sig["R8"][0], sig["R8"][1])
        for m, want in ((msg, True), ((msg + 1) % P, False)):
            assert wc._eddsa_verify(*args, m) is want
            assert j_wc._eddsa_verify(*args, m) is want
    # no point of the curve has this ordinate
    bad = next(y for y in range(2, 50) if not wc._ay_sign_to_ax(y, 0)[1])
    assert wc._ay_sign_to_ax(bad, 0) == j_wc._ay_sign_to_ax(bad, 0)


@pytest.mark.parametrize("kind", ["insert", "update", "delete", "nop"])
def test_witness_check_smt_chains(kind):
    rng = random.Random(12)
    tree = smt.SMT()
    keys = rng.sample(range(1, 1 << 10), 12)
    for k in keys:
        tree.insert(k, rng.randrange(P))
    n = 12
    for k in keys[:4]:
        if kind == "insert":
            pr = tree.insert(k + (1 << 10), rng.randrange(P))
            fnc = (1, 0)
        elif kind == "update":
            pr = tree.update(k, rng.randrange(P))
            fnc = (0, 1)
        elif kind == "delete":
            pr = tree.delete(k)
            pr["new_key"], pr["new_value"] = pr["del_key"], pr["del_value"]
            fnc = (1, 1)
        else:
            pr = dict(old_root=tree.root, new_root=tree.root, siblings=[7],
                      old_key=1, old_value=2, is_old0=False, new_key=3,
                      new_value=4)
            fnc = (0, 0)
        sib = pr["siblings"] + [0] * (n - len(pr["siblings"]))
        args = (sib, pr["old_key"], pr["old_value"], pr["is_old0"],
                pr["new_key"], pr["new_value"], *fnc)
        got = wc.smt_chains_py(*args)
        assert got == j_wc.smt_chains_py(*args)
        res = wc._smt_processor(pr["old_root"], *args)
        assert res == j_wc._smt_processor(pr["old_root"], *args)
        assert res == (pr["new_root"], True)
        if kind != "nop":
            assert got[:2] == (pr["old_root"], pr["new_root"])
            assert wc._smt_processor(pr["old_root"] + 1, *args)[1] is False


def _withdraw_vector(lanes, n_levels):
    """The Withdraw witness vector of valid lanes, made by host code alone
    in the order of `engine/witness_vector.signal_names_withdraw`."""
    w = {"one": 1}
    for i, d in enumerate(lanes):
        eth = int(str(d["ethAddr"]), 0)
        w[f"main.hashGlobalInputs[{i}]"] = \
            withdraw_utils.hash_inputs_withdraw(d)
        for k in ("rootExit", "tokenID", "balance", "idx", "sign", "ay"):
            w[f"main.{k}[{i}]"] = d[k]
        w[f"main.ethAddr[{i}]"] = eth
        sib = d["siblingsState"] + [0] * (n_levels + 1)
        for k in range(n_levels + 1):
            w[f"main.siblingsState[{i}][{k}]"] = sib[k]
        w[f"main.stateHash[{i}]"] = state_utils.hash_state(
            dict(d, nonce=0, ethAddr=eth))
    return w


@pytest.mark.parametrize("tamper", [None, "main.balance[1]", "main.ay[0]",
                                    "main.rootExit[2]", "main.idx[0]",
                                    "main.hashGlobalInputs[1]", "one"])
def test_verify_withdraw_witness_copy(tamper):
    n_levels = 10
    lanes = withdraw_cases.exit_tree_batch(random.Random(13), 3, n_levels)
    w = _withdraw_vector(lanes, n_levels)
    for i, d in enumerate(lanes):
        assert wc._smt_inclusion_root(
            d["siblingsState"] + [0], d["idx"],
            w[f"main.stateHash[{i}]"]) == d["rootExit"]
    if tamper is not None:
        w[tamper] += 1
    res = wc.verify_withdraw_witness(w, n_levels, 3)
    assert res == j_wc.verify_withdraw_witness(w, n_levels, 3)
    assert res["ok"] == (tamper is None), res["failures"]
    assert res["n_checked"] == 1 + 5 * 3
