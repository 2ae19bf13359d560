"""The port's Withdraw slice on the CPU (plain versions of K1 and K4)
against the JAX package and the builder: `ops/smt.verifier` on inclusion,
exclusion (isOld0 0 and 1), disabled lanes and bad proofs;
`hash_inputs_withdrawal` with idx at and past 2^nLevels; `withdraw` with its
debug dict on an exit tree's lanes, valid and tampered; and
`WithdrawEngine.run` / `run_debug` on the end-to-end suite's scenario with
a tampered balance, a hex-string input and a short siblingsState. All of it
is integer arithmetic; every comparison is exact."""

import random
from functools import partial

import jax
import numpy as np
import pytest
import torch

from circuits_tpu.builder.smt import SMT
from circuits_tpu.engine.witness import WithdrawEngine as JaxWithdrawEngine
from circuits_tpu.field import fr as jfr
from circuits_tpu.field.scalar import P
from circuits_tpu.models.hash_inputs import (
    hash_inputs_withdrawal as j_hash_inputs_withdrawal)
from circuits_tpu.models.withdraw import withdraw as j_withdraw
from circuits_tpu.ops import smt as jsmt
from circuits_tpu_torch import convert
from circuits_tpu_torch.builder.withdraw_utils import hash_inputs_withdraw
from circuits_tpu_torch.engine import witness
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.models.hash_inputs import hash_inputs_withdrawal
from circuits_tpu_torch.models.withdraw import withdraw
from circuits_tpu_torch.ops import smt
from circuits_tpu_torch.scripts import withdraw_cases

from torch_compare import assert_same, to_torch

NL = 9  # levels of the verifier's proofs (nLevels + 1)


# ---------------------------------------------------------------------------
# ops/smt.verifier
# ---------------------------------------------------------------------------

def _verifier_lanes():
    """(name, lane dict, expected ok) for one tree of five leaves."""
    t = SMT()
    for k in (1, 2, 3, 9, 17):
        t.insert(k, k * 7)

    def lane(key, value, fnc, enabled=1, root=None, **over):
        f = t.find(key)
        d = dict(enabled=enabled, root=t.root if root is None else root,
                 siblings=f.siblings + [0] * (NL - len(f.siblings)),
                 old_key=f.not_found_key, old_value=f.not_found_value,
                 is_old0=int(f.is_old0), key=key, value=value, fnc=fnc)
        d.update(over)
        return d

    # an exclusion proof into an empty slot, and one against another leaf
    empty = next(k for k in range(20, 200) if t.find(k).is_old0)
    other = next(k for k in range(20, 200)
                 if not t.find(k).is_old0 and not t.find(k).found)
    sib3 = t.find(3).siblings
    return [
        ("inclusion", lane(3, 21, 0), True),
        ("inclusion deep", lane(17, 119, 0), True),
        ("exclusion isOld0=1", lane(empty, 0, 1), True),
        ("exclusion isOld0=0", lane(other, 0, 1), True),
        ("inclusion wrong value", lane(3, 22, 0), False),
        ("wrong root", lane(9, 63, 0, root=(t.root + 1) % P), False),
        ("wrong sibling", lane(3, 21, 0, siblings=[sib3[0] ^ 1] + sib3[1:]
                               + [0] * (NL - len(sib3))), False),
        # exclusion of a key that is there, its own leaf given as the old one
        ("exclusion old_key == key", lane(3, 0, 1, old_key=3, old_value=21,
                                          is_old0=0), False),
        ("exclusion wrong old leaf", lane(other, 0, 1, old_value=5), False),
        ("disabled wrong value", lane(3, 22, 0, enabled=0), True),
        ("disabled wrong root", lane(empty, 0, 1, enabled=0, root=12345),
         True),
    ]


VERIFIER_CASES = [name for name, _, _ in _verifier_lanes()]


def _verifier_args(lanes):
    def col(key):
        return jfr.pack_np([d[key] for d in lanes])

    def flag(key):
        return np.array([d[key] for d in lanes], np.uint32)

    return dict(enabled=flag("enabled"), root=col("root"),
                siblings=np.moveaxis(
                    jfr.pack_np([d["siblings"] for d in lanes]), 2, 0),
                old_key=col("old_key"), old_value=col("old_value"),
                is_old0=flag("is_old0"), key=col("key"), value=col("value"),
                fnc=flag("fnc"))


@pytest.fixture(scope="module")
def verified():
    cases = _verifier_lanes()
    args = _verifier_args([d for _, d, _ in cases])
    want = np.asarray(jax.jit(jsmt.verifier)(**args))
    got = smt.verifier(**{k: to_torch(v) for k, v in args.items()})
    return cases, args, got, want


@pytest.mark.parametrize("name", VERIFIER_CASES)
def test_verifier_matches_jax_and_host(verified, name):
    cases, _, got, want = verified
    i = VERIFIER_CASES.index(name)
    assert got.dtype == torch.bool
    assert bool(got[i]) == bool(want[i]) == cases[i][2], name


def test_verifier_drives_both_exclusion_kinds(verified):
    cases = {name: d for name, d, _ in verified[0]}
    assert cases["exclusion isOld0=1"]["is_old0"] == 1
    assert cases["exclusion isOld0=0"]["is_old0"] == 0
    assert cases["exclusion isOld0=0"]["old_key"] != 0


def test_verifier_states_are_the_jax_state_machine(verified):
    """`verifier_states` against the JAX package's top-down loop, written
    out: top = prev_top & ~levIns, at = prev_top & levIns."""
    sib = to_torch(verified[1]["siblings"])
    top, at = smt.verifier_states(sib)
    lev_ins = np.asarray(jsmt._lev_ins(verified[1]["siblings"]))
    prev = np.ones(lev_ins.shape[1], bool)
    for i in range(NL):
        assert_same(at[i], prev & lev_ins[i], f"at[{i}]")
        prev = prev & ~lev_ins[i]
        assert_same(top[i], prev, f"top[{i}]")


def test_verifier_chain_is_the_processor_old_chain(verified):
    """The verifier's chain is the processor's old chain with masks
    (top, 0, 0, 0, at) and the leaf as old1leaf: on the valid inclusion
    lanes `processor_chain` returns the root."""
    cases, args, _, _ = verified
    lanes = [i for i, (name, _, _) in enumerate(cases)
             if name.startswith("inclusion") and cases[i][2]]
    t = {k: to_torch(v)[..., lanes] for k, v in args.items()}
    top, at = smt.verifier_states(t["siblings"])
    off = torch.zeros_like(top)
    leaf = smt.smt_hash1(t["key"], t["value"])
    old, _ = smt.processor_chain(
        torch.flip(t["siblings"], dims=[0]).contiguous(),
        torch.flip(fr.bits_le(t["key"], NL), dims=[0]).contiguous(),
        torch.flip(torch.stack([top, off, off, off, at], dim=1),
                   dims=[0]).long().contiguous(), leaf, leaf, leaf)
    assert_same(old, t["root"])


# ---------------------------------------------------------------------------
# models/hash_inputs.hash_inputs_withdrawal
# ---------------------------------------------------------------------------

HASH_NLEVELS = 16


@pytest.fixture(scope="module")
def hashed():
    rng = np.random.default_rng(20261016)

    def below(bits, n):
        return [int.from_bytes(rng.bytes(32), "little") % (1 << bits)
                for _ in range(n)]

    idx = [0, 1, (1 << HASH_NLEVELS) - 1, 1 << HASH_NLEVELS,
           (1 << HASH_NLEVELS) + 5, (1 << 48) - 1, 1 << 47, 300]
    n = len(idx)
    cols = dict(rootExit=[v % P for v in below(254, n)],
                ethAddr=below(160, n), tokenID=below(32, n),
                balance=below(192, n), idx=idx)
    cols["ethAddr"][0] = (1 << 160) - 1
    cols["balance"][1] = (1 << 192) - 1
    cols["tokenID"][2] = (1 << 32) - 1
    order = ("rootExit", "ethAddr", "tokenID", "balance", "idx")
    packed = [jfr.pack_np(cols[k]) for k in order]
    want = jax.jit(partial(j_hash_inputs_withdrawal, HASH_NLEVELS))(*packed)
    got = hash_inputs_withdrawal(HASH_NLEVELS, *map(to_torch, packed))
    return cols, got, want


def test_hash_inputs_withdrawal_matches_jax(hashed):
    _, got, want = hashed
    assert_same(got[0], want[0], "hash")
    assert_same(got[1], want[1], "ok")


def test_hash_inputs_withdrawal_matches_builder(hashed):
    cols, got, _ = hashed
    hashes = [int(v) for v in fr.unpack_np(got[0])]
    for i, h in enumerate(hashes):
        assert h == hash_inputs_withdraw({k: v[i] for k, v in cols.items()})


def test_hash_inputs_withdrawal_range_check_on_idx(hashed):
    cols, got, _ = hashed
    assert got[1].tolist() == [v < (1 << HASH_NLEVELS) for v in cols["idx"]]


# ---------------------------------------------------------------------------
# models/withdraw.withdraw on an exit tree's lanes
# ---------------------------------------------------------------------------

TREE_NLEVELS = 8
N_VALID = 12


@pytest.fixture(scope="module")
def tree_lanes():
    """12 valid withdrawals out of one exit tree, then one lane of each
    tampered kind: 16 lanes."""
    lanes = withdraw_cases.exit_tree_batch(random.Random(5), N_VALID,
                                           TREE_NLEVELS)
    assert all(d["siblingsState"] for d in lanes)
    return lanes + [withdraw_cases.tamper(lanes[i], kind, TREE_NLEVELS)
                    for i, kind in enumerate(withdraw_cases.TAMPERS)]


@pytest.fixture(scope="module")
def withdrawn(tree_lanes):
    packed = witness.pack_withdraw_inputs(tree_lanes, TREE_NLEVELS,
                                          device="cpu")
    got = withdraw(TREE_NLEVELS, **packed, debug=True)
    want = jax.jit(partial(j_withdraw, TREE_NLEVELS, debug=True))(
        *convert.withdraw_args_to_jax(packed))
    return got, want


@pytest.mark.parametrize("part", ["hash", "ok", "state_hash"])
def test_withdraw_matches_jax(withdrawn, part):
    got, want = withdrawn
    i = ["hash", "ok", "state_hash"].index(part)
    assert_same(convert.debug_to_numpy(got[i]), want[i], part)


def test_withdraw_accepts_the_valid_lanes_with_the_builders_hash(
        withdrawn, tree_lanes):
    h, ok, _ = withdrawn[0]
    assert ok[:N_VALID].all()
    assert [int(v) for v in fr.unpack_np(h)] == \
        [hash_inputs_withdraw(d) for d in tree_lanes]


@pytest.mark.parametrize("kind", withdraw_cases.TAMPERS)
def test_withdraw_refuses_each_tamper(withdrawn, kind):
    _, ok, _ = withdrawn[0]
    assert not bool(ok[N_VALID + withdraw_cases.TAMPERS.index(kind)])


def test_withdraw_without_debug_returns_two(tree_lanes, withdrawn):
    packed = witness.pack_withdraw_inputs(tree_lanes[:2], TREE_NLEVELS,
                                          device="cpu")
    h, ok = withdraw(TREE_NLEVELS, **packed)
    assert_same(h, withdrawn[0][0][:, :2])
    assert_same(ok, withdrawn[0][1][:2])


def test_bulk_tree_is_the_tree_of_single_inserts():
    rng = random.Random(3)
    items = [(k, rng.randrange(P)) for k in rng.sample(range(1, 1 << 12), 200)]
    one_by_one = SMT()
    for k, v in items:
        one_by_one.insert(k, v)
    bulk = withdraw_cases.bulk_tree(items)
    assert bulk.root == one_by_one.root
    for k, v in items[::7]:
        got, want = bulk.find(k), one_by_one.find(k)
        assert got.found and got.found_value == v
        assert got.siblings == want.siblings


# ---------------------------------------------------------------------------
# engine/witness.WithdrawEngine on the end-to-end suite's scenario
# ---------------------------------------------------------------------------

SUITE_NLEVELS = 16


def _suite_withdrawal():
    """tests/test_engine_e2e.py::test_withdraw_engine's input: account 256
    exits 400 of its 1000, then withdraws them."""
    from circuits_tpu_torch.builder import float40
    from circuits_tpu_torch.builder.account import HermezAccount
    from circuits_tpu_torch.builder.rollup_db import RollupDB
    from circuits_tpu_torch.builder.state_utils import Constants

    cfg = (3, SUITE_NLEVELS, 2, 2)
    a1 = HermezAccount(1)
    db = RollupDB()
    bb = db.build_batch(*cfg)
    bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(1000), tokenID=1,
                   fromBjjCompressed=a1.bjjCompressed,
                   fromEthAddr=a1.ethAddr, toIdx=0, onChain=True))
    bb.build()
    db.consolidate(bb)
    bb2 = db.build_batch(*cfg)
    tx = dict(fromIdx=256, toIdx=Constants.exitIdx, tokenID=1, amount=400,
              userFee=0, nonce=0, onChain=0)
    a1.sign_tx(tx)
    bb2.add_tx(tx)
    bb2.build()
    db.consolidate(bb2)
    info = db.get_exit_tree_info(256, db.last_batch)
    st = info["state"]
    return dict(rootExit=info["root"], ethAddr=st["ethAddr"],
                tokenID=st["tokenID"], balance=st["balance"], idx=256,
                sign=st["sign"], ay=st["ay"],
                siblingsState=info["siblings"])


ENGINE_LANES = ["valid", "tampered balance", "hex strings",
                "zero siblings given"]


@pytest.fixture(scope="module")
def engine_runs():
    winp = _suite_withdrawal()
    assert len(winp["siblingsState"]) < SUITE_NLEVELS + 1  # short: padded
    batch = [winp, dict(winp, balance=winp["balance"] + 1),
             dict(winp, ethAddr=hex(winp["ethAddr"]), ay=hex(winp["ay"]),
                  rootExit=hex(winp["rootExit"])),
             dict(winp, siblingsState=[0] * (SUITE_NLEVELS + 1))]
    eng = witness.WithdrawEngine(SUITE_NLEVELS, device="cpu")
    jeng = JaxWithdrawEngine(SUITE_NLEVELS)
    return (winp, eng.run(batch), jeng.run(batch), eng.run_debug(batch),
            jeng.run_debug(batch))


@pytest.mark.parametrize("lane", ENGINE_LANES)
def test_engine_run_matches_jax(engine_runs, lane):
    i = ENGINE_LANES.index(lane)
    winp, (h, ok), (jh, jok), _, _ = engine_runs
    assert isinstance(h[i], int) and h[i] == jh[i]
    assert bool(ok[i]) == bool(jok[i]) == (lane != "tampered balance")
    if lane != "tampered balance":
        assert h[i] == hash_inputs_withdraw(winp)


def test_engine_ok_is_a_numpy_bool_array(engine_runs):
    _, (_, ok), (_, jok), (_, ok_dbg, _), _ = engine_runs
    for a in (ok, ok_dbg):
        assert isinstance(a, np.ndarray) and a.dtype == np.bool_
        assert a.shape == np.asarray(jok).shape
        assert a.tolist() == np.asarray(jok).tolist()


def test_engine_run_debug_matches_jax(engine_runs):
    _, (h, _), _, (h_dbg, _, dbg), (jh, _, jdbg) = engine_runs
    assert h_dbg == h == jh
    assert sorted(dbg) == sorted(jdbg) == ["state_hash"]
    assert_same(convert.debug_to_numpy(dbg), jdbg, "dbg")


def test_packing_pads_siblings_and_reads_hex(engine_runs):
    winp = engine_runs[0]
    lanes = [winp, dict(winp, ethAddr=hex(winp["ethAddr"]),
                        siblingsState=[5, 6])]
    packed = witness.pack_withdraw_inputs(lanes, SUITE_NLEVELS, device="cpu")
    assert sorted(packed) == sorted(convert.WITHDRAW_ARGS)
    assert tuple(packed["siblings_state"].shape) == (SUITE_NLEVELS + 1, 16, 2)
    assert packed["siblings_state"][:, 0, 1].tolist() == \
        [5, 6] + [0] * (SUITE_NLEVELS - 1)
    assert_same(packed["eth_addr"][:, 0], packed["eth_addr"][:, 1])
    assert packed["sign"].dtype == torch.int64
    for k in ("root_exit", "eth_addr", "token_id", "balance", "idx", "ay"):
        assert tuple(packed[k].shape) == (16, 2), k


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        witness.WithdrawEngine(SUITE_NLEVELS)
    with pytest.raises(RuntimeError, match="cuda"):
        witness.pack_withdraw_inputs([], SUITE_NLEVELS)
