"""The reference's own check of a RollupMain witness vector: every exported
signal re-derived in Python bigints from the vector's section IN, and every
`===` relation of the circuit checked on it.

A copy of the port's `circuits_tpu_torch/r1cs/witness_check.py`
(`verify_witness`) that imports nothing of the port: its Poseidon, its
BabyJubJub, its fee table, its field and its SHA-256 are the reference's
(`poseidon_constants.poseidon_py`, native where g++ builds it, `babyjub`,
`fee_table`, `scalar`, `sha256_py`), the circuit's constants are written in
as literals with the circom lines they come from, and the canonical name
list (`signal_names`) and the `.wtns` reader and writer are copies too.

Departures from the original, each noted at its place:
  - the check is split in three, so that the lanes can be checked apart:
    the head (the constant signal and the binarity checks of
    rollup-main:206-218, over every lane), the lanes (`verify_lanes` on a
    range of them: each lane reads its chained inputs, the `im*` signals,
    from section IN) and the tail (`verify_tail`: the fee slots, the
    hash-inputs ranges and the SHA-256 preimage), which takes from the
    last lane's part the two values the original carries out of its loop;
    `verify_witness` runs the three in the original's order and gives its
    failures, one for one, in the same order;
  - `verify_files` runs the lane part over ranges of lanes on a pool of
    processes, each reading the `.wtns` file itself;
  - the Withdraw check is left out.
"""

from __future__ import annotations

import multiprocessing
import os
import struct
from pathlib import Path

from .babyjub import BASE8, add_point, mul_point, mul_point_generic
from .fee_table import BITS_SHIFT, TABLE_ADJUSTED_FEE
from .poseidon_constants import poseidon_py
from .scalar import P, fsqrt
from .sha256_py import sha256_bits_py

BJJ_A, BJJ_D = 168700, 168696
MAX_NLEVELS = 48

# the circuit's constants, as literals (the original imports them from the
# port's models)
CONST_SIG = 3322668559                                 # decode-tx.circom:353
L1_TX_FULL_BITS = 160 + 256 + 48 + 40 + 40 + 32 + 48   # decode-tx.circom:73
ETH_ADDR_ANY = (1 << 160) - 1                    # rollup-tx-states.circom:131
EXIT_IDX = 1                                     # rollup-tx-states.circom:141


def l1l2_bits(n_levels: int) -> int:
    return 2 * n_levels + 40 + 8  # decode-tx.circom:57


# ---------------------------------------------------------------------------
# the canonical name list (a copy of the port's
# engine/witness_vector.py:signal_names, names only)
# ---------------------------------------------------------------------------

# per-lane circuit inputs, in src/rollup-main.circom declaration order
# (:127-161); (name, kind) with kind "field" | "flag" | "bits256" |
# "siblings"
TX_INPUTS = [
    ("txCompressedData", "field"), ("amountF", "field"),
    ("txCompressedDataV2", "field"), ("fromIdx", "field"),
    ("auxFromIdx", "field"), ("toIdx", "field"), ("auxToIdx", "field"),
    ("toBjjAy", "field"), ("toEthAddr", "field"),
    ("maxNumBatch", "field"), ("onChain", "flag"),
    ("newAccount", "flag"), ("rqOffset", "flag"),
    ("rqTxCompressedDataV2", "field"), ("rqToEthAddr", "field"),
    ("rqToBjjAy", "field"), ("s", "field"), ("r8x", "field"),
    ("r8y", "field"), ("loadAmountF", "field"),
    ("fromEthAddr", "field"), ("fromBjjCompressed", "bits256"),
    ("tokenID1", "field"), ("nonce1", "field"), ("sign1", "flag"),
    ("balance1", "field"), ("ay1", "field"), ("ethAddr1", "field"),
    ("siblings1", "siblings"), ("isOld0_1", "flag"),
    ("oldKey1", "field"), ("oldValue1", "field"),
    ("tokenID2", "field"), ("nonce2", "field"), ("sign2", "flag"),
    ("balance2", "field"), ("ay2", "field"), ("ethAddr2", "field"),
    ("siblings2", "siblings"), ("isOld0_2", "flag"),
    ("newExit", "flag"), ("oldKey2", "field"), ("oldValue2", "field"),
]

# per-fee-slot leaf inputs (:163-171)
FEE_INPUTS = [
    ("tokenID3", "field"), ("nonce3", "field"), ("sign3", "flag"),
    ("balance3", "field"), ("ay3", "field"), ("ethAddr3", "field"),
    ("siblings3", "siblings"),
]

DEC_SIGNALS = ["fromIdx", "toIdx", "tokenID", "nonce", "userFee",
               "toBjjSign", "amount", "sigL2Hash", "txCompressedDataV2",
               "outIdx"]
STATE_SIGNALS = ["isP1Insert", "isP2Insert", "key1", "key2", "P1_fnc0",
                 "P1_fnc1", "P2_fnc0", "P2_fnc1", "isExit",
                 "verifySignEnabled", "nop", "checkToEthAddr", "checkToBjj",
                 "nullifyLoadAmount", "nullifyAmount", "finalFromIdx",
                 "finalToIdx", "isAmount"]
MUX_SIGNALS = ["balance", "sign", "ay", "nonce", "ethAddr", "tokenID",
               "oldKey", "oldValue"]
BAL_SIGNALS = ["fee2Charge", "newStBalanceSender", "newStBalanceReceiver",
               "isP2Nop", "isAmountNullified"]


def in_names(T: int, F: int, L: int) -> list[str]:
    """Section IN (src/rollup-main.circom:105-196 order)."""
    names = ["main.oldLastIdx", "main.oldStateRoot",
             "main.globalChainID", "main.currentNumBatch"]
    names += [f"main.feeIdxs[{j}]" for j in range(F)]
    names += [f"main.feePlanTokens[{j}]" for j in range(F)]
    names += [f"main.imOnChain[{i}]" for i in range(T - 1)]
    names += [f"main.imOutIdx[{i}]" for i in range(T - 1)]
    names += [f"main.imStateRoot[{i}]" for i in range(T - 1)]
    names += [f"main.imExitRoot[{i}]" for i in range(T - 1)]
    for i in range(T - 1):
        names += [f"main.imAccFeeOut[{i}][{j}]" for j in range(F)]
    names += [f"main.imStateRootFee[{j}]" for j in range(F - 1)]
    names += ["main.imInitStateRootFee"]
    names += [f"main.imFinalAccFee[{j}]" for j in range(F)]
    for i in range(T):
        for name, kind in TX_INPUTS:
            if kind == "bits256":
                names += [f"main.{name}[{i}][{b}]" for b in range(256)]
            elif kind == "siblings":
                names += [f"main.{name}[{i}][{k}]" for k in range(L)]
            else:
                names.append(f"main.{name}[{i}]")
    for j in range(F):
        for name, kind in FEE_INPUTS:
            if kind == "siblings":
                names += [f"main.{name}[{j}][{k}]" for k in range(L)]
            else:
                names.append(f"main.{name}[{j}]")
    return names


def signal_names(n_tx: int, n_levels: int, max_l1_tx: int,
                 max_fee_tx: int) -> list[str]:
    """The canonical, parameter-determined name list; the witness vector
    is exactly these signals in this order."""
    T, F, L = n_tx, max_fee_tx, n_levels + 1
    names = ["one", "main.hashGlobalInputs"] + in_names(T, F, L)

    # ---- section DEC ----
    nl1l2 = l1l2_bits(n_levels)
    for i in range(T):
        names += [f"main.Decoder[{i}].{s}" for s in DEC_SIGNALS]
        names += [f"main.Decoder[{i}].L1L2TxData[{b}]"
                  for b in range(nl1l2)]
        names += [f"main.Decoder[{i}].L1TxFullData[{b}]"
                  for b in range(L1_TX_FULL_BITS)]

    # ---- section TX ----
    for i in range(T):
        tx = f"main.Tx[{i}]"
        names.append(f"{tx}.decodeLoadAmount")
        names += [f"{tx}.states.{s}" for s in STATE_SIGNALS]
        names += [f"{tx}.decodeFromBjj.ay", f"{tx}.decodeFromBjj.sign"]
        names += [f"{tx}.s1.{s}" for s in MUX_SIGNALS]
        names += [f"{tx}.s2.{s}" for s in MUX_SIGNALS]
        names += [f"{tx}.oldStHash1", f"{tx}.oldStHash2"]
        names += [f"{tx}.sigAy", f"{tx}.sigSign", f"{tx}.sigAx"]
        names += [f"{tx}.balance.{s}" for s in BAL_SIGNALS]
        names += [f"{tx}.accFeeOut[{j}]" for j in range(F)]
        names += [f"{tx}.newNonce1", f"{tx}.newStHash1",
                  f"{tx}.newStHash2"]
        names += [f"{tx}.P1.enabled", f"{tx}.P1.newRoot",
                  f"{tx}.P2.enabled", f"{tx}.P2.newRoot"]
        names += [f"{tx}.newStateRoot", f"{tx}.newExitRoot",
                  f"{tx}.isAmountNullified"]

    # ---- section FEE ----
    for j in range(F):
        ft = f"main.FeeTx[{j}]"
        names += [f"{ft}.oldStHash", f"{ft}.newBalance",
                  f"{ft}.newStHash", f"{ft}.newRoot"]

    # ---- section TAIL ----
    names += ["main.newLastIdx", "main.newStateRoot", "main.newExitRoot"]
    names += [f"main.accFeeOut[{j}]" for j in range(F)]
    return names


def in_values(inp: dict, n_tx: int, n_levels: int, max_l1_tx: int,
              max_fee_tx: int) -> list[int]:
    """Section IN of a batch's vector, from its input dict (as the port's
    export writes it)."""
    T, F = n_tx, max_fee_tx

    def gi(key):
        return [int(v) for v in inp[key]]

    values = [int(inp[k]) for k in ("oldLastIdx", "oldStateRoot",
                                    "globalChainID", "currentNumBatch")]
    for key in ("feeIdxs", "feePlanTokens", "imOnChain", "imOutIdx",
                "imStateRoot", "imExitRoot"):
        values += gi(key)
    for i in range(T - 1):
        values += [int(v) for v in inp["imAccFeeOut"][i]]
    values += gi("imStateRootFee")
    values.append(int(inp["imInitStateRootFee"]))
    values += gi("imFinalAccFee")
    for i in range(T):
        for name, kind in TX_INPUTS:
            if kind in ("bits256", "siblings"):
                values += [int(v) for v in inp[name][i]]
            else:
                values.append(int(inp[name][i]) % P)
    for j in range(F):
        for name, kind in FEE_INPUTS:
            if kind == "siblings":
                values += [int(s) for s in inp[name][j]]
            else:
                values.append(int(inp[name][j]))
    return values


# ---------------------------------------------------------------------------
# the .wtns container (snarkjs v2: magic, version 2, two sections; section 1
# n8, the prime and the count; section 2 the values, 32 bytes little-endian)
# ---------------------------------------------------------------------------

def le_bytes(values) -> bytes:
    """Each value as 32 little-endian bytes, as it is."""
    return b"".join(int(v).to_bytes(32, "little") for v in values)


def wtns_bytes(values: list[int]) -> bytes:
    """The container of `values`, each written as it is (a copy of the
    port's `write_wtns`, which reduces each value mod p first: here a value
    in [p, 2^256) is written unreduced, so that the control can be)."""
    sec1 = struct.pack("<I", 32) + P.to_bytes(32, "little") + \
        struct.pack("<I", len(values))
    sec2 = le_bytes(values)
    return (b"wtns" + struct.pack("<II", 2, 2)
            + struct.pack("<IQ", 1, len(sec1)) + sec1
            + struct.pack("<IQ", 2, len(sec2)) + sec2)


HEADER_BYTES = 12 + 12 + 40 + 12  # magic to the values section's header


def wtns_values(data: bytes, count: int) -> memoryview | None:
    """The values section of a container holding `count` values, laid out
    as the port writes it: magic "wtns", version 2, two sections, n8 32,
    the BN254 prime, the count, then 32 bytes a value; None for any other
    layout."""
    if len(data) != HEADER_BYTES + 32 * count or data[:4] != b"wtns":
        return None
    if struct.unpack_from("<II", data, 4) != (2, 2):
        return None
    if struct.unpack_from("<IQI", data, 12) != (1, 40, 32):
        return None
    if int.from_bytes(data[28:60], "little") != P:
        return None
    if struct.unpack_from("<I", data, 60)[0] != count:
        return None
    if struct.unpack_from("<IQ", data, 64) != (2, 32 * count):
        return None
    return memoryview(data)[HEADER_BYTES:]


def to_ints(section) -> list[int]:
    """32-byte little-endian values to Python ints."""
    raw = bytes(section)
    return [int.from_bytes(raw[k:k + 32], "little")
            for k in range(0, len(raw), 32)]


# ---------------------------------------------------------------------------
# host mirrors of the gadget functions (independent int formulations),
# verbatim
# ---------------------------------------------------------------------------

def _decode_float(f: int) -> int:
    m, e = f & ((1 << 35) - 1), f >> 35
    return m * pow(10, e, P) % P


def _compute_fee(fee_sel: int, amount: int, apply_fee: bool):
    """Mirror of ops/gadgets.compute_fee (src/compute-fee.circom:12-94).
    Returns (fee_out, ok)."""
    sel_eff = fee_sel if apply_fee else 0
    fns = TABLE_ADJUSTED_FEE[sel_eff] * amount % P
    in_range = fns < (1 << 253)
    apply_shift = not ((fee_sel >> 6) & (fee_sel >> 7) & 1)
    if apply_shift:
        fee_out = (fns >> BITS_SHIFT) & ((1 << 128) - 1)
        ov = (fns >> (BITS_SHIFT + 128)) != 0 if in_range else True
    else:
        fee_out = fns & ((1 << 128) - 1)
        ov = (fns >> 128) != 0 if in_range else True
    return fee_out, in_range and not ov


def _hash_state(token_id, nonce, sign, balance, ay, eth_addr) -> int:
    e0 = (token_id + nonce * (1 << 32) + sign * (1 << 72)) % P
    return poseidon_py([e0, balance, ay, eth_addr])


def _ay_sign_to_ax(ay: int, sign: int):
    """Mirror of ops/babyjubjub.ay_sign_to_ax (Bits2Point_Strict).
    Returns (ax, ok)."""
    y2 = ay * ay % P
    num = (1 - y2) % P
    den = (BJJ_A - BJJ_D * y2) % P
    if den == 0:
        return 0, False
    x2 = num * pow(den, -1, P) % P
    root = fsqrt(x2)
    if root is None:
        return 0, False
    ax = (P - root) % P if sign else root
    return ax, True


def _eddsa_verify(ax, ay, s, r8x, r8y, msg) -> bool:
    """circomlib EdDSAPoseidonVerifier relation with the engine's scalar
    truncations (s: 253 bits, challenge: 254 bits)."""
    hm = poseidon_py([r8x, r8y, ax, ay, msg]) & ((1 << 254) - 1)
    lhs = mul_point(s & ((1 << 253) - 1), BASE8)
    rhs = add_point((r8x, r8y), mul_point_generic(hm, (ax, ay)))
    return lhs == rhs


def smt_chains_py(siblings, old_key, old_value, is_old0,
                  new_key, new_value, fnc0, fnc1):
    """Host mirror of ops/smt.processor_chains (circomlib
    SMTProcessorSM/Levels semantics). siblings: root-down list, length n.
    Returns (computed_old, computed_new, enabled)."""
    n = len(siblings)
    enabled = bool(fnc0 or fnc1)
    f_insert = fnc0 and not fnc1
    f_update = fnc1 and not fnc0
    f_delete = fnc0 and fnc1
    f_ins_like = f_insert or f_delete

    isz = [s == 0 for s in siblings]
    lev_ins, suffix_zero = [], True
    for i in range(n - 1, -1, -1):
        suffix_zero = suffix_zero and isz[i]
        lev_ins.append(suffix_zero and (i == 0 or not isz[i - 1]))
    lev_ins.reverse()

    old_bits = [(old_key >> i) & 1 for i in range(n)]
    new_bits = [(new_key >> i) & 1 for i in range(n)]
    xors = [a ^ b for a, b in zip(old_bits, new_bits)]

    st = []
    prev_top, prev_bot = True, False
    for i in range(n):
        li = lev_ins[i]
        top = prev_top and not li
        old0 = prev_top and li and is_old0 and f_ins_like
        bot = ((prev_top and li and not is_old0 and f_ins_like
                and not xors[i]) or (prev_bot and not xors[i]))
        new1 = ((prev_top and li and not is_old0 and f_ins_like
                 and xors[i]) or (prev_bot and xors[i]))
        upd = prev_top and li and f_update
        st.append((top, old0, bot, new1, upd))
        prev_top, prev_bot = top, bot

    old1leaf = poseidon_py([old_key, old_value, 1])
    new1leaf = poseidon_py([new_key, new_value, 1])

    old_child, new_child = 0, 0
    for i in range(n - 1, -1, -1):
        top, old0, bot, new1, upd = st[i]
        sib, bit = siblings[i], new_bits[i]
        ol, orr = (sib, old_child) if bit else (old_child, sib)
        nl, nr = (sib, new_child) if bit else (new_child, sib)
        n1l, n1r = (old1leaf, new1leaf) if bit else (new1leaf, old1leaf)
        bl, br = (0, new_child) if bit else (new_child, 0)
        old_up = poseidon_py([ol, orr]) if top else 0
        if bot or new1 or upd:
            old_up = old1leaf
        if top:
            new_up = poseidon_py([nl, nr])
        elif bot:
            new_up = poseidon_py([bl, br])
        elif new1:
            new_up = poseidon_py([n1l, n1r])
        elif old0 or upd:
            new_up = new1leaf
        else:
            new_up = 0
        old_child, new_child = old_up, new_up

    if f_delete:
        return new_child, old_child, enabled
    return old_child, new_child, enabled


def _smt_processor(old_root, siblings, old_key, old_value, is_old0,
                   new_key, new_value, fnc0, fnc1):
    """Returns (new_root, ok) mirroring ops/smt.processor."""
    co, cn, enabled = smt_chains_py(
        siblings, old_key, old_value, is_old0, new_key, new_value,
        fnc0, fnc1)
    ok = True
    if enabled:
        ok = (co == old_root) and (siblings[-1] == 0)
    return (cn if enabled else old_root), ok


def _be(v: int, nbits: int) -> str:
    return format(v, f"0{nbits}b")


# ---------------------------------------------------------------------------
# the verifier, in three parts
# ---------------------------------------------------------------------------

class _Check:
    def __init__(self):
        self.failures: list[str] = []
        self.n_checked = 0

    def ok(self, cond: bool, name: str):
        self.n_checked += 1
        if not cond:
            self.failures.append(name)

    def eq(self, got, want, name: str):
        self.ok(got == want, f"{name} (got {got}, want {want})")

    def result(self, **extra) -> dict:
        return dict(failures=self.failures, n_checked=self.n_checked,
                    **extra)


class _Batch:
    """The batch's section-IN signals that the lanes and the tail share
    (the original reads them before its lane loop)."""

    def __init__(self, w: dict, n_tx: int, max_fee_tx: int):
        T, F = n_tx, max_fee_tx

        def lane(name, i):
            return w[f"main.{name}[{i}]"]

        self.old_last_idx = w["main.oldLastIdx"]
        self.old_state_root = w["main.oldStateRoot"]
        self.chain_id = w["main.globalChainID"]
        self.num_batch = w["main.currentNumBatch"]
        self.im_on_chain = [lane("imOnChain", i) for i in range(T - 1)]
        self.im_out_idx = [lane("imOutIdx", i) for i in range(T - 1)]
        self.im_state_root = [lane("imStateRoot", i) for i in range(T - 1)]
        self.im_exit_root = [lane("imExitRoot", i) for i in range(T - 1)]
        self.im_acc_fee = [[w[f"main.imAccFeeOut[{i}][{j}]"]
                            for j in range(F)] for i in range(T - 1)]
        self.im_state_root_fee = [lane("imStateRootFee", j)
                                  for j in range(F - 1)]
        self.im_init_state_root_fee = w["main.imInitStateRootFee"]
        self.im_final_acc_fee = [lane("imFinalAccFee", j) for j in range(F)]
        self.fee_plan_tokens = [lane("feePlanTokens", j) for j in range(F)]
        self.fee_idxs = [lane("feeIdxs", j) for j in range(F)]


def verify_head(w: dict[str, int], n_tx: int, n_levels: int,
                max_l1_tx: int, max_fee_tx: int) -> dict:
    """The original's checks before its lane loop: the constant signal and
    the binarity checks of every lane. Returns dict(failures,
    n_checked)."""
    T = n_tx
    c = _Check()
    c.eq(w["one"], 1, "one")
    im_on_chain = [w[f"main.imOnChain[{i}]"] for i in range(T - 1)]

    # rollup-main.circom:206-218 binarity checks
    for i in range(T - 1):
        c.ok(im_on_chain[i] <= 1, f"imOnChain[{i}] binary (:208)")
    for i in range(T):
        for f in ("onChain", "newAccount", "isOld0_1", "isOld0_2"):
            c.ok(w[f"main.{f}[{i}]"] <= 1, f"{f}[{i}] binary (:212)")
        for b in range(256):
            c.ok(w[f"main.fromBjjCompressed[{i}][{b}]"] <= 1,
                 f"fromBjjCompressed[{i}][{b}] binary (:215)")
    return c.result()


def verify_lanes(w: dict[str, int], n_tx: int, n_levels: int,
                 max_l1_tx: int, max_fee_tx: int, lo: int = 0,
                 hi: int | None = None) -> dict:
    """The original's lane loop on lanes [lo, hi). Returns dict(failures,
    n_checked, carry): `carry` is, where the range holds the last lane,
    (its new exit root, its outIdx), which the tail takes; else None."""
    T, F, L = n_tx, max_fee_tx, n_levels + 1
    hi = T if hi is None else hi
    c = _Check()
    bt = _Batch(w, T, F)
    carry = None

    def g(name):
        return w[name]

    def lane(name, i):
        return w[f"main.{name}[{i}]"]

    def sibs(name, i):
        return [w[f"main.{name}[{i}][{k}]"] for k in range(L)]

    old_last_idx, old_state_root = bt.old_last_idx, bt.old_state_root
    chain_id, num_batch = bt.chain_id, bt.num_batch
    im_on_chain, im_out_idx = bt.im_on_chain, bt.im_out_idx
    im_state_root, im_exit_root = bt.im_state_root, bt.im_exit_root
    im_acc_fee, im_init_state_root_fee = bt.im_acc_fee, \
        bt.im_init_state_root_fee
    im_final_acc_fee, fee_plan_tokens = bt.im_final_acc_fee, \
        bt.fee_plan_tokens

    nl1l2 = l1l2_bits(n_levels)

    for i in range(lo, hi):
        pre = f"main.Tx[{i}]"
        dpre = f"main.Decoder[{i}]"
        on_chain = bool(lane("onChain", i))
        new_account = bool(lane("newAccount", i))
        prev_on_chain = bool(im_on_chain[i - 1]) if i > 0 else True
        in_idx = im_out_idx[i - 1] if i > 0 else old_last_idx
        lane_old_state_root = im_state_root[i - 1] if i > 0 \
            else old_state_root
        lane_old_exit_root = im_exit_root[i - 1] if i > 0 else 0
        acc_fee_in = im_acc_fee[i - 1] if i > 0 else [0] * F
        last = i == T - 1

        # ---------------- DecodeTx ----------------
        d = lane("txCompressedData", i)
        c.ok(d < (1 << 225), f"txCompressedData[{i}] 225-bit")
        from_idx = (d >> 48) & ((1 << 48) - 1)
        to_idx = (d >> 96) & ((1 << 48) - 1)
        token_id = (d >> 144) & ((1 << 32) - 1)
        nonce = (d >> 176) & ((1 << 40) - 1)
        user_fee = (d >> 216) & 0xFF
        to_bjj_sign = (d >> 224) & 1
        c.eq(g(f"{dpre}.fromIdx"), from_idx, f"{dpre}.fromIdx")
        c.eq(g(f"{dpre}.toIdx"), to_idx, f"{dpre}.toIdx")
        c.eq(g(f"{dpre}.tokenID"), token_id, f"{dpre}.tokenID")
        c.eq(g(f"{dpre}.nonce"), nonce, f"{dpre}.nonce")
        c.eq(g(f"{dpre}.userFee"), user_fee, f"{dpre}.userFee")
        c.eq(g(f"{dpre}.toBjjSign"), to_bjj_sign, f"{dpre}.toBjjSign")
        # idx padding (decode-tx.circom:124,:137)
        c.ok(from_idx < (1 << n_levels), f"fromIdx[{i}] pad (:124)")
        c.ok(to_idx < (1 << n_levels), f"toIdx[{i}] pad (:137)")

        amount_f = lane("amountF", i)
        c.ok(amount_f < (1 << 40), f"amountF[{i}] 40-bit")
        amount = _decode_float(amount_f)
        c.eq(g(f"{dpre}.amount"), amount, f"{dpre}.amount")

        # txCompressedDataV2 rebuild (:174-212) + im pin (:259)
        v2 = 0 if on_chain else (
            from_idx | (to_idx << 48) | (amount_f << 96)
            | (token_id << 136) | (nonce << 168) | (user_fee << 208))
        v2 |= to_bjj_sign << 216
        c.eq(g(f"{dpre}.txCompressedDataV2"), v2,
             f"{dpre}.txCompressedDataV2")
        c.eq(lane("txCompressedDataV2", i), v2,
             f"im txCompressedDataV2[{i}] (rollup-main:259)")

        # sigL2Hash (:249-283)
        to_eth = lane("toEthAddr", i)
        mnb = lane("maxNumBatch", i)
        c.ok(to_eth < (1 << 160), f"toEthAddr[{i}] 160-bit")
        c.ok(mnb < (1 << 32), f"maxNumBatch[{i}] 32-bit")
        element1 = to_eth | (amount_f << 160) | (mnb << 200)
        sig_l2 = poseidon_py([
            d, element1, lane("toBjjAy", i),
            lane("rqTxCompressedDataV2", i), lane("rqToEthAddr", i),
            lane("rqToBjjAy", i)])
        c.eq(g(f"{dpre}.sigL2Hash"), sig_l2, f"{dpre}.sigL2Hash")

        # ordering / account-creation checks (:326-368)
        c.eq(on_chain and from_idx == 0, new_account,
             f"newAccount[{i}] (decode-tx:331)")
        out_idx = (in_idx + 1) % P if (on_chain and new_account) else in_idx
        c.eq(g(f"{dpre}.outIdx"), out_idx, f"{dpre}.outIdx")
        if on_chain and new_account:
            c.eq(lane("auxFromIdx", i), out_idx,
                 f"auxFromIdx[{i}] (decode-tx:338)")
        if not last:
            c.eq(im_on_chain[i], int(on_chain),
                 f"imOnChain[{i}] (rollup-main:263)")
            c.eq(im_out_idx[i], out_idx,
                 f"imOutIdx[{i}] (rollup-main:264)")
        c.ok(not ((not prev_on_chain) and on_chain),
             f"L1-before-L2 ordering[{i}] (decode-tx:344)")
        if not on_chain:
            c.eq(chain_id, (d >> 32) & 0xFFFF,
                 f"chainID[{i}] (decode-tx:347)")
            c.eq(d & 0xFFFFFFFF, CONST_SIG,
                 f"constSig[{i}] (decode-tx:355)")
        c.ok(mnb == 0 or num_batch <= mnb,
             f"maxNumBatch[{i}] (decode-tx:360-368)")

        # DA bitstrings (:214-247, :285-324)
        load_f = lane("loadAmountF", i)
        from_eth = lane("fromEthAddr", i)
        c.ok(load_f < (1 << 40), f"loadAmountF[{i}] 40-bit")
        c.ok(from_eth < (1 << 160), f"fromEthAddr[{i}] 160-bit")
        bjj_bits_le = [w[f"main.fromBjjCompressed[{i}][{b}]"]
                       for b in range(256)]
        # final receiver idx for DA (:221-230)
        final_to_da = lane("auxToIdx", i) \
            if (not on_chain and to_idx == 0) else to_idx
        l1l2_str = (_be(from_idx, n_levels)[-n_levels:]
                    + _be(final_to_da, n_levels)[-n_levels:]
                    + _be(amount_f, 40)
                    + _be(0 if on_chain else user_fee, 8))
        got_l1l2 = "".join(str(w[f"{dpre}.L1L2TxData[{b}]"])
                           for b in range(nl1l2))
        c.eq(got_l1l2, l1l2_str, f"{dpre}.L1L2TxData")
        bjj_cm = sum(b << k for k, b in enumerate(bjj_bits_le))
        l1full_str = (_be(from_eth, 160) + _be(bjj_cm, 256)
                      + _be(from_idx, 48) + _be(load_f, 40)
                      + _be(amount_f, 40) + _be(token_id, 32)
                      + _be(to_idx, 48)) if on_chain \
            else "0" * L1_TX_FULL_BITS
        got_l1full = "".join(str(w[f"{dpre}.L1TxFullData[{b}]"])
                             for b in range(L1_TX_FULL_BITS))
        c.eq(got_l1full, l1full_str, f"{dpre}.L1TxFullData")

        # ---------------- RollupTx phase A: loadAmount + states --------
        load_amount = _decode_float(load_f)
        c.eq(g(f"{pre}.decodeLoadAmount"), load_amount,
             f"{pre}.decodeLoadAmount")

        aux_from = lane("auxFromIdx", i)
        aux_to = lane("auxToIdx", i)
        new_exit = bool(lane("newExit", i))
        token_id1 = lane("tokenID1", i)
        token_id2 = lane("tokenID2", i)
        eth_addr1 = lane("ethAddr1", i)

        sel_aux_from = on_chain and new_account
        final_from_idx = aux_from if sel_aux_from else from_idx
        select_aux_to = (not on_chain) and to_idx == 0
        final_to_idx = aux_to if select_aux_to else to_idx
        is_to_any = to_eth == ETH_ADDR_ANY
        is_exit = final_to_idx == EXIT_IDX
        is_final_from = final_from_idx != 0
        is_load_amount = load_amount != 0
        is_amount = amount != 0
        # hard constraints (rollup-tx-states:172,:175)
        c.ok(not ((not on_chain) and is_load_amount),
             f"L2 loadAmount[{i}] (rollup-tx-states:172)")
        c.ok(not ((not on_chain) and new_account),
             f"L2 newAccount[{i}] (rollup-tx-states:175)")

        is_p1_insert = on_chain and new_account
        p1_fnc0 = is_p1_insert and is_final_from
        p1_fnc1 = (not is_p1_insert) and is_final_from
        key1 = final_from_idx if (p1_fnc0 or p1_fnc1) else 0
        is_p2_insert = is_exit and new_exit
        p2_fnc0 = is_p2_insert and is_final_from
        p2_fnc1 = (not is_p2_insert) and is_final_from
        key2 = ((final_from_idx if is_amount else 0) if is_exit
                else (final_to_idx if is_amount else 0))
        vse = (not on_chain) and is_final_from
        nop = not is_final_from
        tmp_eth = (not is_to_any) and select_aux_to
        tmp_bjj = is_to_any and select_aux_to
        check_to_eth = tmp_eth and not nop
        check_to_bjj = tmp_bjj and not nop
        oc_not_create = (not new_account) and on_chain
        apply_null_eth = (oc_not_create and is_amount
                          and from_eth != eth_addr1)
        apply_null_tok1 = oc_not_create and token_id != token_id1
        apply_null_tok2 = (on_chain and is_amount and not is_p2_insert
                           and token_id != token_id2)
        nullify_load = apply_null_tok1 and is_load_amount
        nullify_amount = (apply_null_eth or apply_null_tok2
                          or (apply_null_tok1 and is_amount))

        expected_states = dict(
            isP1Insert=is_p1_insert, isP2Insert=is_p2_insert,
            key1=key1, key2=key2, P1_fnc0=p1_fnc0, P1_fnc1=p1_fnc1,
            P2_fnc0=p2_fnc0, P2_fnc1=p2_fnc1, isExit=is_exit,
            verifySignEnabled=vse, nop=nop,
            checkToEthAddr=check_to_eth, checkToBjj=check_to_bjj,
            nullifyLoadAmount=nullify_load, nullifyAmount=nullify_amount,
            finalFromIdx=final_from_idx, finalToIdx=final_to_idx,
            isAmount=is_amount)
        for k, v in expected_states.items():
            c.eq(g(f"{pre}.states.{k}"), int(v), f"{pre}.states.{k}")

        # ---------------- phase B: rq links ----------------
        rq_off = lane("rqOffset", i)

        def nb(name, j):
            return lane(name, j) if 0 <= j < T else 0

        rq_map = {0: None, 1: i + 1, 2: i + 2, 3: i + 3,
                  4: i - 4, 5: i - 3, 6: i - 2, 7: i - 1}
        tgt = rq_map[rq_off]
        for fld, rq_fld in (("txCompressedDataV2", "rqTxCompressedDataV2"),
                            ("toEthAddr", "rqToEthAddr"),
                            ("toBjjAy", "rqToBjjAy")):
            want = nb(fld, tgt) if tgt is not None else 0
            c.eq(lane(rq_fld, i), want,
                 f"rq link {rq_fld}[{i}] (rq-tx-verifier:91-93)")

        # ---------------- phase C: ForceEqualIfEnabled bank ------------
        if not on_chain:
            c.eq(nonce, lane("nonce1", i),
                 f"nonce[{i}] (rollup-tx:237)")
            c.eq(token_id, token_id1, f"tokenID1[{i}] (rollup-tx:266)")
            if not is_p2_insert:
                c.eq(token_id, token_id2,
                     f"tokenID2[{i}] (rollup-tx:273)")
        if check_to_eth or check_to_bjj:
            c.eq(to_eth, lane("ethAddr2", i),
                 f"toEthAddr[{i}] (rollup-tx:245)")
        if check_to_bjj:
            c.eq(lane("ay2", i), lane("toBjjAy", i),
                 f"toBjjAy[{i}] (rollup-tx:253)")
            c.eq(lane("sign2", i), to_bjj_sign,
                 f"toBjjSign[{i}] (rollup-tx:259)")
        if is_p1_insert:
            c.eq(token_id, token_id1, f"tokenID1[{i}] (rollup-tx:281)")
            c.eq(from_eth, eth_addr1,
                 f"fromEthAddr[{i}] (rollup-tx:289)")

        # ---------------- phase D: old state hashes ----------------
        old_st1 = _hash_state(token_id1, lane("nonce1", i),
                              lane("sign1", i), lane("balance1", i),
                              lane("ay1", i), eth_addr1)
        old_st2 = _hash_state(token_id2, lane("nonce2", i),
                              lane("sign2", i), lane("balance2", i),
                              lane("ay2", i), lane("ethAddr2", i))
        c.eq(g(f"{pre}.oldStHash1"), old_st1, f"{pre}.oldStHash1")
        c.eq(g(f"{pre}.oldStHash2"), old_st2, f"{pre}.oldStHash2")

        # ---------------- phase E: leaf mux bank ----------------
        dec_ay = bjj_cm & ((1 << 254) - 1)
        dec_sign = bjj_bits_le[255]
        c.eq(g(f"{pre}.decodeFromBjj.ay"), dec_ay,
             f"{pre}.decodeFromBjj.ay")
        c.eq(g(f"{pre}.decodeFromBjj.sign"), dec_sign,
             f"{pre}.decodeFromBjj.sign")
        p1i, p2i = is_p1_insert, is_p2_insert
        s1 = dict(
            balance=0 if p1i else lane("balance1", i),
            sign=dec_sign if p1i else lane("sign1", i),
            ay=dec_ay if p1i else lane("ay1", i),
            nonce=0 if p1i else lane("nonce1", i),
            ethAddr=from_eth if p1i else eth_addr1,
            tokenID=token_id if p1i else token_id1,
            oldKey=lane("oldKey1", i) if p1i else key1,
            oldValue=lane("oldValue1", i) if p1i else old_st1)
        s2 = dict(
            balance=0 if p2i else lane("balance2", i),
            sign=s1["sign"] if p2i else lane("sign2", i),
            ay=s1["ay"] if p2i else lane("ay2", i),
            nonce=0 if p2i else lane("nonce2", i),
            ethAddr=s1["ethAddr"] if p2i else lane("ethAddr2", i),
            tokenID=s1["tokenID"] if p2i else token_id2,
            oldKey=lane("oldKey2", i) if p2i else key2,
            oldValue=lane("oldValue2", i) if p2i else old_st2)
        for side, d_ in (("s1", s1), ("s2", s2)):
            for k, v in d_.items():
                c.eq(g(f"{pre}.{side}.{k}"), int(v), f"{pre}.{side}.{k}")

        # ---------------- phase F: EdDSA ----------------
        sig_sign = s1["sign"] if vse else 0
        sig_ay = s1["ay"] if vse else 0
        c.eq(g(f"{pre}.sigAy"), sig_ay, f"{pre}.sigAy")
        c.eq(g(f"{pre}.sigSign"), int(sig_sign), f"{pre}.sigSign")
        ax, ax_ok = _ay_sign_to_ax(sig_ay, sig_sign)
        c.ok(ax_ok, f"{pre} Bits2Point_Strict on-curve")
        c.eq(g(f"{pre}.sigAx"), ax, f"{pre}.sigAx")
        if vse:
            c.ok(_eddsa_verify(ax, s1["ay"], lane("s", i),
                               lane("r8x", i), lane("r8y", i), sig_l2),
                 f"{pre} EdDSAPoseidonVerifier identity")

        # ---------------- phase G: balance updater ----------------
        apply_fee = (not on_chain) and (not nop)
        fee2, fee_ok = _compute_fee(user_fee, amount, apply_fee)
        c.ok(fee_ok, f"{pre} ComputeFee overflow (compute-fee:86-91)")
        c.eq(g(f"{pre}.balance.fee2Charge"), fee2,
             f"{pre}.balance.fee2Charge")
        eff_load = (load_amount if on_chain else 0)
        if nullify_load:
            eff_load = 0
        eff_amount1 = 0 if nop else amount
        eff_amount2 = 0 if nullify_amount else eff_amount1
        bal1, bal2 = s1["balance"], s2["balance"]
        acc = ((1 << 192) + bal1 + eff_load - eff_amount2 - fee2) % P
        in_range = acc < (1 << 193)
        underflow_ok = in_range and bool((acc >> 192) & 1)
        c.ok(in_range, f"{pre} underflow Num2Bits(193) range")
        c.ok(underflow_ok or on_chain,
             f"{pre} L2 underflow (balance-updater:83)")
        eff_amount3 = eff_amount2 if underflow_ok else 0
        new_sender = (bal1 + eff_load - eff_amount3 - fee2) % P
        new_receiver = (bal2 + eff_amount3) % P
        c.eq(g(f"{pre}.balance.newStBalanceSender"), new_sender,
             f"{pre}.balance.newStBalanceSender")
        c.eq(g(f"{pre}.balance.newStBalanceReceiver"), new_receiver,
             f"{pre}.balance.newStBalanceReceiver")
        is_amount_nullified = nullify_amount or not underflow_ok
        is_p2_nop = eff_amount1 != 0
        c.eq(g(f"{pre}.balance.isP2Nop"), int(is_p2_nop),
             f"{pre}.balance.isP2Nop")
        c.eq(g(f"{pre}.balance.isAmountNullified"),
             int(is_amount_nullified), f"{pre}.balance.isAmountNullified")
        c.eq(g(f"{pre}.isAmountNullified"), int(is_amount_nullified),
             f"{pre}.isAmountNullified")

        # ---------------- phase H: fee accumulator ----------------
        selected = False
        for j in range(F):
            match = (token_id == fee_plan_tokens[j]) and not selected
            want = (acc_fee_in[j] + fee2) % P if match else acc_fee_in[j]
            selected = selected or (token_id == fee_plan_tokens[j])
            c.eq(g(f"{pre}.accFeeOut[{j}]"), want,
                 f"{pre}.accFeeOut[{j}]")
            # im pin (rollup-main:387/:430)
            pin = im_acc_fee[i][j] if not last else im_final_acc_fee[j]
            c.eq(want, pin, f"imAccFeeOut[{i}][{j}] (rollup-main:387)")

        # ---------------- phase I: new state hashes ----------------
        new_nonce1 = s1["nonce"] if on_chain else (s1["nonce"] + 1) % P
        c.eq(g(f"{pre}.newNonce1"), new_nonce1, f"{pre}.newNonce1")
        new_st1 = _hash_state(s1["tokenID"], new_nonce1, s1["sign"],
                              new_sender, s1["ay"], s1["ethAddr"])
        new_st2 = _hash_state(s2["tokenID"], s2["nonce"], s2["sign"],
                              new_receiver, s2["ay"], s2["ethAddr"])
        c.eq(g(f"{pre}.newStHash1"), new_st1, f"{pre}.newStHash1")
        c.eq(g(f"{pre}.newStHash2"), new_st2, f"{pre}.newStHash2")

        # ---------------- phase J: SMT processors ----------------
        sib1 = sibs("siblings1", i)
        sib2 = sibs("siblings2", i)
        c.eq(g(f"{pre}.P1.enabled"), int(p1_fnc0 or p1_fnc1),
             f"{pre}.P1.enabled")
        p1_root, p1_ok = _smt_processor(
            lane_old_state_root, sib1, s1["oldKey"], s1["oldValue"],
            bool(lane("isOld0_1", i)), key1, new_st1, p1_fnc0, p1_fnc1)
        c.ok(p1_ok, f"{pre} SMTProcessor1 old-root/top-sibling")
        c.eq(g(f"{pre}.P1.newRoot"), p1_root, f"{pre}.P1.newRoot")

        p2f0 = p2_fnc0 and is_p2_nop
        p2f1 = p2_fnc1 and is_p2_nop
        c.eq(g(f"{pre}.P2.enabled"), int(p2f0 or p2f1),
             f"{pre}.P2.enabled")
        p2_old_root = lane_old_exit_root if is_exit else p1_root
        p2_root, p2_ok = _smt_processor(
            p2_old_root, sib2, s2["oldKey"], s2["oldValue"],
            bool(lane("isOld0_2", i)), key2, new_st2, p2f0, p2f1)
        c.ok(p2_ok, f"{pre} SMTProcessor2 old-root/top-sibling")
        c.eq(g(f"{pre}.P2.newRoot"), p2_root, f"{pre}.P2.newRoot")

        # ---------------- phase K + im pins ----------------
        new_state_root = p1_root if is_exit else p2_root
        new_exit_root = p2_root if is_exit else lane_old_exit_root
        c.eq(g(f"{pre}.newStateRoot"), new_state_root,
             f"{pre}.newStateRoot")
        c.eq(g(f"{pre}.newExitRoot"), new_exit_root,
             f"{pre}.newExitRoot")
        pin_root = im_state_root[i] if not last else im_init_state_root_fee
        c.eq(new_state_root, pin_root,
             f"imStateRoot[{i}] (rollup-main:384/:427)")
        if not last:
            c.eq(new_exit_root, im_exit_root[i],
                 f"imExitRoot[{i}] (rollup-main:385)")
        else:
            # the original keeps these for its tail (final_exit_root,
            # final_last_idx); here they are handed to `verify_tail`
            carry = (new_exit_root, out_idx)
    return c.result(carry=carry)


def verify_tail(w: dict[str, int], n_tx: int, n_levels: int,
                max_l1_tx: int, max_fee_tx: int, carry: tuple) -> dict:
    """The original's checks after its lane loop: the fee phase, the
    outputs, the hash-inputs ranges and the SHA-256 of the global inputs.
    `carry` is the last lane's (new exit root, outIdx), from
    `verify_lanes`. Returns dict(failures, n_checked)."""
    T, F, L = n_tx, max_fee_tx, n_levels + 1
    c = _Check()
    bt = _Batch(w, T, F)
    final_exit_root, final_last_idx = carry

    def g(name):
        return w[name]

    def lane(name, i):
        return w[f"main.{name}[{i}]"]

    def sibs(name, i):
        return [w[f"main.{name}[{i}][{k}]"] for k in range(L)]

    fee_idxs, fee_plan_tokens = bt.fee_idxs, bt.fee_plan_tokens
    im_final_acc_fee = bt.im_final_acc_fee
    im_state_root_fee = bt.im_state_root_fee
    old_last_idx, old_state_root = bt.old_last_idx, bt.old_state_root
    chain_id, num_batch = bt.chain_id, bt.num_batch
    nl1l2 = l1l2_bits(n_levels)

    # ---------------- fee phase (rollup-main:391-431) ----------------
    fee_root_in = bt.im_init_state_root_fee
    for j in range(F):
        fpre = f"main.FeeTx[{j}]"
        fee_idx = fee_idxs[j]
        active = fee_idx != 0
        if active:
            c.eq(fee_plan_tokens[j], lane("tokenID3", j),
                 f"feePlanToken[{j}] (fee-tx:53)")
        new_balance = (im_final_acc_fee[j] + lane("balance3", j)) % P
        old_h = _hash_state(lane("tokenID3", j), lane("nonce3", j),
                            lane("sign3", j), lane("balance3", j),
                            lane("ay3", j), lane("ethAddr3", j))
        new_h = _hash_state(lane("tokenID3", j), lane("nonce3", j),
                            lane("sign3", j), new_balance,
                            lane("ay3", j), lane("ethAddr3", j))
        c.eq(g(f"{fpre}.oldStHash"), old_h, f"{fpre}.oldStHash")
        c.eq(g(f"{fpre}.newBalance"), new_balance, f"{fpre}.newBalance")
        c.eq(g(f"{fpre}.newStHash"), new_h, f"{fpre}.newStHash")
        root_out, f_ok = _smt_processor(
            fee_root_in, sibs("siblings3", j), fee_idx, old_h, False,
            fee_idx, new_h, False, active)
        c.ok(f_ok, f"{fpre} SMTProcessor old-root/top-sibling")
        c.eq(g(f"{fpre}.newRoot"), root_out, f"{fpre}.newRoot")
        if j < F - 1:
            c.eq(root_out, im_state_root_fee[j],
                 f"imStateRootFee[{j}] (rollup-main:423)")
        fee_root_in = root_out

    # ---------------- tail: outputs + global hash ----------------
    c.eq(g("main.newLastIdx"), final_last_idx, "main.newLastIdx")
    c.eq(g("main.newStateRoot"), fee_root_in, "main.newStateRoot")
    c.eq(g("main.newExitRoot"), final_exit_root, "main.newExitRoot")
    for j in range(F):
        c.eq(g(f"main.accFeeOut[{j}]"), im_final_acc_fee[j],
             f"main.accFeeOut[{j}]")

    # hash-inputs residuals (:57-98)
    c.ok(old_last_idx < (1 << n_levels), "oldLastIdx range (:61)")
    c.ok(g("main.newLastIdx") < (1 << n_levels), "newLastIdx range (:71)")
    for j in range(F):
        c.ok(fee_idxs[j] < (1 << n_levels), f"feeIdxs[{j}] range (:98)")

    # the SHA256 preimage, rebuilt from the vector's DA bit signals with
    # the nullified-amount zeroing (rollup-main:456-459)
    pieces = [_be(old_last_idx, MAX_NLEVELS),
              _be(g("main.newLastIdx"), MAX_NLEVELS),
              _be(old_state_root, 256),
              _be(g("main.newStateRoot"), 256),
              _be(g("main.newExitRoot"), 256)]
    for i in range(max_l1_tx):
        pieces.append("".join(
            str(w[f"main.Decoder[{i}].L1TxFullData[{b}]"])
            for b in range(L1_TX_FULL_BITS)))
    for i in range(T):
        bits = [w[f"main.Decoder[{i}].L1L2TxData[{b}]"]
                for b in range(nl1l2)]
        if w[f"main.Tx[{i}].isAmountNullified"]:
            for b in range(2 * n_levels, 2 * n_levels + 40):
                bits[b] = 0
        pieces.append("".join(str(b) for b in bits))
    for j in range(F):
        pieces.append(_be(fee_idxs[j], n_levels)[-n_levels:])
    pieces.append(_be(chain_id, 16))
    pieces.append(_be(num_batch, 32))
    digest = sha256_bits_py("".join(pieces)) % P
    c.eq(g("main.hashGlobalInputs"), digest,
         "main.hashGlobalInputs (hash-inputs:179-184)")
    return c.result()


def verify_witness(w: dict[str, int], n_tx: int, n_levels: int,
                   max_l1_tx: int, max_fee_tx: int) -> dict:
    """Re-check every circuit relation from the exported vector alone: the
    head, every lane and the tail in the original's order. Returns
    dict(ok, failures, n_checked), the original's."""
    params = (n_tx, n_levels, max_l1_tx, max_fee_tx)
    head = verify_head(w, *params)
    lanes = verify_lanes(w, *params)
    tail = verify_tail(w, *params, lanes["carry"])
    failures = head["failures"] + lanes["failures"] + tail["failures"]
    return dict(ok=not failures, failures=failures,
                n_checked=head["n_checked"] + lanes["n_checked"]
                + tail["n_checked"])


# ---------------------------------------------------------------------------
# the lanes over a pool of processes
# ---------------------------------------------------------------------------

# a pool process's vector: the path it was read from, its shape and the
# {name: value} dict (None where the file is not laid out for the shape)
_held: dict = {}


def _lane_task(task):
    path, params, lo, hi = task
    try:
        if _held.get("key") != (path, params):
            _held.clear()
            _held["w"] = load_vector(path, signal_names(*params))
            _held["key"] = (path, params)
        if _held["w"] is None:
            raise ValueError(f"{path} is not a vector of {params}")
        return verify_lanes(_held["w"], *params, lo, hi)
    except Exception as e:  # a vector the original would raise on
        return dict(failures=[f"lanes [{lo}, {hi}) raised {e!r}"],
                    n_checked=0, carry=None)


def ranges(n: int, parts: int) -> list[tuple[int, int]]:
    """[0, n) in `parts` (at most n) consecutive ranges."""
    parts = max(1, min(parts, n))
    cuts = [n * k // parts for k in range(parts + 1)]
    return list(zip(cuts, cuts[1:]))


def verify_files(paths: dict, params: tuple,
                 workers: int | None = None) -> dict:
    """`verify_witness` on the vector of each `.wtns` file of `paths`
    ({key: path}, each laid out for `params`): its lanes over ranges on a
    pool of `workers` processes (`os.cpu_count()` by default; each reads
    the file itself), its head and tail here. Returns {key: dict(ok,
    failures, n_checked)}; a part that raises counts as one failure."""
    workers = workers or os.cpu_count() or 1
    tasks = [(str(path), tuple(params), lo, hi)
             for path in paths.values()
             for lo, hi in ranges(params[0], 4 * workers)]
    if workers > 1 and len(tasks) > 1:
        # spawned, not forked: the caller may hold threads (a device
        # runtime's) that a fork would copy mid-lock
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(tasks))) as pool:
            parts = pool.map(_lane_task, tasks, chunksize=1)
    else:
        parts = [_lane_task(t) for t in tasks]
    names = signal_names(*params)
    out = {}
    for key, path in paths.items():
        mine = [p for t, p in zip(tasks, parts) if t[0] == str(path)]
        failures, n_checked = [], 0
        for part in mine:
            failures += part["failures"]
            n_checked += part["n_checked"]
        w = load_vector(path, names)
        try:
            if w is None:
                raise ValueError(f"{path} is not a vector of {params}")
            head = verify_head(w, *params)
            carry = mine[-1]["carry"]
            if carry is None:
                raise ValueError("the last lane gave nothing to carry")
            tail = verify_tail(w, *params, carry)
            failures = head["failures"] + failures + tail["failures"]
            n_checked += head["n_checked"] + tail["n_checked"]
        except Exception as e:
            failures.append(f"head or tail raised {e!r}")
        out[key] = dict(ok=not failures, failures=failures,
                        n_checked=n_checked)
    return out


def load_vector(path: str | Path, names: list[str]) -> dict | None:
    """{name: value} of a `.wtns` file laid out for `names`; None where
    its layout is another."""
    section = wtns_values(Path(path).read_bytes(), len(names))
    if section is None:
        return None
    return dict(zip(names, to_ints(section)))
