"""Full witness vector export — the prover handoff artifact.

Port of `circuits_tpu/engine/witness_vector.py`. The reference's native
witness calculator writes every circuit signal to `witness.json` / `.wtns`,
which snarkjs consumes for Groth16 proving (tools/helpers/actions.js:
132-146, :168-185). This module is that artifact for this engine: a
COMPLETE, canonically-ordered, signal-indexed vector of every value the
monomorphized circuit evaluates. The names, the order and the container
bytes are the JAX package's; the values are read from the torch debug
dicts, each tensor brought to the host once.

Canonical ordering (documented contract; does not reuse circom's `.sym`
numbering — the engine monomorphizes by its parameters, not by circom
codegen — but is complete and deterministic given the circuit parameters
(nTx, nLevels, maxL1Tx, maxFeeTx)):

  index 0                      "one" — the constant-1 signal (circom
                               witness convention: w[0] = 1)
  section OUT                  the public output main.hashGlobalInputs
  section IN                   every circuit input, in the declaration
                               order of src/rollup-main.circom:105-196:
                               batch scalars, fee plan, im chains, then
                               per-tx-lane inputs (lane-major), then
                               per-fee-slot leaf inputs
  section DEC  (per lane)      every DecodeTx intermediate incl. the DA
                               bitstrings L1L2TxData / L1TxFullData as
                               individual bit signals
  section TX   (per lane)      every RollupTx phase A-K intermediate:
                               the states decision table, the phase-E
                               leaf mux bank, state hashes, EdDSA
                               signals, balance updater, fee
                               accumulator slots, processor roots,
                               output roots
  section FEE  (per fee slot)  FeeTx intermediates: old/new leaf hash,
                               new balance, output root
  section TAIL                 batch outputs: newLastIdx, final state /
                               exit roots, accFeeOut

Granularity: one signal per gadget-level value (every named wire of the
reference's own src templates). Gadget-internal wires of circomlib
primitives (Poseidon round states, SHA256 schedule words, per-level SMT
node hashes, EdDSA ladder points) are evaluated by construction inside
fused kernels and are not materialized — r1cs/witness_check.py proves
they need not be: it re-derives every exported signal from the section-IN
signals alone and re-checks every reference `===` residual
(r1cs/audit.py MANIFEST) using only this vector.

Binary format: the snarkjs `.wtns` container (magic "wtns", version 2,
section 1 = field header, section 2 = 32-byte little-endian values) plus
a JSON sidecar mapping canonical names to indices (the `.sym` analogue).

`handoff(engine, inp, path)` is the coordinator's step after a batch: the
vector written as a `.wtns` where the circuit accepts the batch, nothing
where it refuses it (the reference's witness calculator stops there with
"Constraint doesn't match"). `export_witness` shares its body and exports
whatever the verdict. Spans (`spans.py`): `export.handoff` around a
handoff; `export.evaluate` the pack and the debug graph up to the
verdict; `export.read` the device's values to the Python int vector
(counter `export_values`); `export.write` the file (counter
`wtns_bytes`).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

from .. import spans
from ..field import fr, limbs
from ..field.scalar import P
from ..models.decode_tx import L1_TX_FULL_BITS, l1l2_bits

# per-lane circuit inputs, in src/rollup-main.circom declaration order
# (:127-161); (name, kind) with kind "field" | "flag" | "bits256"
_TX_INPUTS = [
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
_FEE_INPUTS = [
    ("tokenID3", "field"), ("nonce3", "field"), ("sign3", "flag"),
    ("balance3", "field"), ("ay3", "field"), ("ethAddr3", "field"),
    ("siblings3", "siblings"),
]

# DecodeTx intermediates: canonical name suffix -> key in the decode
# debug dict ("bits:<key>" marks a bitstring group)
_DEC_SIGNALS = [
    ("fromIdx", "from_idx"), ("toIdx", "to_idx"),
    ("tokenID", "token_id"), ("nonce", "nonce"),
    ("userFee", "user_fee"), ("toBjjSign", "to_bjj_sign"),
    ("amount", "amount"), ("sigL2Hash", "sig_l2_hash"),
    ("txCompressedDataV2", "tx_compressed_data_v2"),
    ("outIdx", "out_idx"),
]

# RollupTxStates outputs (src/rollup-tx-states.circom)
_STATE_SIGNALS = [
    ("isP1Insert", "is_p1_insert"), ("isP2Insert", "is_p2_insert"),
    ("key1", "key1"), ("key2", "key2"),
    ("P1_fnc0", "p1_fnc0"), ("P1_fnc1", "p1_fnc1"),
    ("P2_fnc0", "p2_fnc0"), ("P2_fnc1", "p2_fnc1"),
    ("isExit", "is_exit"),
    ("verifySignEnabled", "verify_sign_enabled"),
    ("nop", "nop"),
    ("checkToEthAddr", "check_to_eth_addr"),
    ("checkToBjj", "check_to_bjj"),
    ("nullifyLoadAmount", "nullify_load_amount"),
    ("nullifyAmount", "nullify_amount"),
    ("finalFromIdx", "final_from_idx"),
    ("finalToIdx", "final_to_idx"),
    ("isAmount", "is_amount"),
]

# phase-E leaf mux bank (src/rollup-tx.circom:314-443), per side
_MUX_SIGNALS = ["balance", "sign", "ay", "nonce", "ethAddr", "tokenID",
                "oldKey", "oldValue"]
_MUX_KEYS = ["balance", "sign", "ay", "nonce", "eth_addr", "token_id",
             "old_key", "old_value"]

# BalanceUpdater outputs (src/balance-updater.circom)
_BAL_SIGNALS = [
    ("fee2Charge", "fee2_charge"),
    ("newStBalanceSender", "new_balance_sender"),
    ("newStBalanceReceiver", "new_balance_receiver"),
    ("isP2Nop", "is_p2_nop"),
    ("isAmountNullified", "is_amount_nullified"),
]


def signal_names(n_tx: int, n_levels: int, max_l1_tx: int,
                 max_fee_tx: int) -> list[str]:
    """The canonical, parameter-determined name list; the witness vector
    is exactly these signals in this order."""
    T, F, L = n_tx, max_fee_tx, n_levels + 1
    names = ["one", "main.hashGlobalInputs"]

    # ---- section IN (src/rollup-main.circom:105-196 order) ----
    names += ["main.oldLastIdx", "main.oldStateRoot",
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
        for name, kind in _TX_INPUTS:
            if kind == "bits256":
                names += [f"main.{name}[{i}][{b}]" for b in range(256)]
            elif kind == "siblings":
                names += [f"main.{name}[{i}][{k}]" for k in range(L)]
            else:
                names.append(f"main.{name}[{i}]")
    for j in range(F):
        for name, kind in _FEE_INPUTS:
            if kind == "siblings":
                names += [f"main.{name}[{j}][{k}]" for k in range(L)]
            else:
                names.append(f"main.{name}[{j}]")

    # ---- section DEC ----
    nl1l2 = l1l2_bits(n_levels)
    for i in range(T):
        names += [f"main.Decoder[{i}].{s}" for s, _ in _DEC_SIGNALS]
        names += [f"main.Decoder[{i}].L1L2TxData[{b}]"
                  for b in range(nl1l2)]
        names += [f"main.Decoder[{i}].L1TxFullData[{b}]"
                  for b in range(L1_TX_FULL_BITS)]

    # ---- section TX ----
    for i in range(T):
        tx = f"main.Tx[{i}]"
        names.append(f"{tx}.decodeLoadAmount")
        names += [f"{tx}.states.{s}" for s, _ in _STATE_SIGNALS]
        names += [f"{tx}.decodeFromBjj.ay", f"{tx}.decodeFromBjj.sign"]
        names += [f"{tx}.s1.{s}" for s in _MUX_SIGNALS]
        names += [f"{tx}.s2.{s}" for s in _MUX_SIGNALS]
        names += [f"{tx}.oldStHash1", f"{tx}.oldStHash2"]
        names += [f"{tx}.sigAy", f"{tx}.sigSign", f"{tx}.sigAx"]
        names += [f"{tx}.balance.{s}" for s, _ in _BAL_SIGNALS]
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


def _ints(arr) -> list[int]:
    """(16, B) canonical limb tensor -> list of B python ints."""
    return fr.unpack_np(arr).tolist()


def _flags(arr) -> list[int]:
    """(B,) bool or 0/1 tensor -> list of B python ints 0/1."""
    return [int(v) for v in fr.to_numpy(arr).reshape(-1)]


def _column(arr) -> list[int]:
    """A per-lane signal that is a field (16, B) in some groups and a flag
    (B,) in others."""
    return _ints(arr) if arr.dim() == 2 else _flags(arr)


def _evaluate(engine, inp: dict):
    """One debug evaluation of the whole circuit through the engine's
    captured `debug_call`: (lanes, outputs, ok), the verdict read back."""
    with spans.span("export.evaluate"):
        lanes, _lane_ok, out, ok = engine._full_debug(inp)
        return lanes, out, bool(ok)


def _vector(engine, inp: dict, lanes: dict, out: dict) -> list[int]:
    """The canonical vector of one evaluation: every signal's value brought
    to the host as a Python int, in `signal_names` order."""
    with spans.span("export.read"):
        values = _values(engine, inp, lanes, out)
        spans.count("export_values", len(values))
        return values


def export_witness(engine, inp: dict) -> tuple[list[str], list[int]]:
    """Evaluate the full witness for a builder/JSON input dict.

    Returns (names, values) in canonical order, whatever the verdict.
    `engine` is a RollupEngine; one debug evaluation computes every
    signal."""
    lanes, out, _ = _evaluate(engine, inp)
    values = _vector(engine, inp, lanes, out)
    names = signal_names(*engine.params)
    assert len(names) == len(values), (len(names), len(values))
    return names, values


def handoff(engine, inp: dict, path: str | Path):
    """The prover's handoff of one batch: evaluate it, and where the
    circuit accepts it write the full vector to `path` as a `.wtns`.

    Returns (outputs, ok). A batch the circuit refuses writes nothing,
    reads nothing back and returns (None, False), as the reference's
    witness calculator stops at a constraint that does not hold. Otherwise
    the outputs are the public ones as `RollupEngine.run` keys them, read
    from the vector written."""
    with spans.span("export.handoff"):
        lanes, out, ok = _evaluate(engine, inp)
        if not ok:
            return None, False
        values = _vector(engine, inp, lanes, out)
        with spans.span("export.write"):
            spans.count("wtns_bytes", write_wtns(path, values))
        F = engine.params[3]
        tail = len(values) - F - 3  # newLastIdx, the two roots, accFeeOut
        return dict(hash_global_inputs=values[1],
                    new_state_root=values[tail + 1],
                    new_exit_root=values[tail + 2],
                    new_last_idx=values[tail],
                    acc_fee_out=values[tail + 3:]), True


def _values(engine, inp: dict, lanes: dict, out: dict) -> list[int]:
    n_tx, n_levels, max_l1_tx, max_fee_tx = engine.params
    T, F, L = n_tx, max_fee_tx, n_levels + 1

    def gi(key):  # input value list (per-lane camelCase key)
        return [int(v) for v in inp[key]]

    values: list[int] = [1]
    values.append(fr.unpack_int(out["hash_global_inputs"]))

    # ---- section IN: straight from the input dict ----
    for k in ("oldLastIdx", "oldStateRoot", "globalChainID",
              "currentNumBatch"):
        values.append(int(inp[k]))
    values += gi("feeIdxs")
    values += gi("feePlanTokens")
    values += gi("imOnChain")
    values += gi("imOutIdx")
    values += gi("imStateRoot")
    values += gi("imExitRoot")
    for i in range(T - 1):
        values += [int(v) for v in inp["imAccFeeOut"][i]]
    values += gi("imStateRootFee")
    values.append(int(inp["imInitStateRootFee"]))
    values += gi("imFinalAccFee")
    for i in range(T):
        for name, kind in _TX_INPUTS:
            if kind == "bits256":
                values += [int(b) for b in inp[name][i]]
            elif kind == "siblings":
                values += [int(s) for s in inp[name][i]]
            else:
                values.append(int(inp[name][i]) % P)
    for j in range(F):
        for name, kind in _FEE_INPUTS:
            if kind == "siblings":
                values += [int(s) for s in inp[name][j]]
            else:
                values.append(int(inp[name][j]))

    # ---- section DEC ----
    dec = lanes["decode"]
    dec_cols = {s: _ints(dec[k]) if k not in ("to_bjj_sign",)
                else _flags(dec[k]) for s, k in _DEC_SIGNALS}
    # bit rows of one lane: the lane axis first, then plain Python ints
    # (nl1l2, T) and (624, T) -> a row of bits a lane
    l1l2 = fr.to_numpy(dec["l1l2_tx_data"].long()).T.tolist()
    l1full = fr.to_numpy(dec["l1_tx_full_data"].long()).T.tolist()
    for i in range(T):
        values += [dec_cols[s][i] for s, _ in _DEC_SIGNALS]
        values += l1l2[i]
        values += l1full[i]

    # ---- section TX ----
    tx = lanes["tx"]
    st = tx["states"]
    bal = tx["balance"]
    cols = {}
    cols["decodeLoadAmount"] = _ints(bal["load_amount"])
    for s, k in _STATE_SIGNALS:
        cols[f"states.{s}"] = _column(st[k])
    cols["decodeFromBjj.ay"] = _ints(tx["decode_ay"])
    cols["decodeFromBjj.sign"] = _flags(tx["decode_sign"])
    for side in ("s1", "s2"):
        for s, k in zip(_MUX_SIGNALS, _MUX_KEYS):
            cols[f"{side}.{s}"] = _column(tx[side][k])
    for nm, k in (("oldStHash1", "old_state_hash1"),
                  ("oldStHash2", "old_state_hash2"),
                  ("sigAy", "sig_ay"), ("sigAx", "sig_ax"),
                  ("newNonce1", "new_nonce1"),
                  ("newStHash1", "new_state_hash1"),
                  ("newStHash2", "new_state_hash2"),
                  ("P1.newRoot", "p1_new_root"),
                  ("P2.newRoot", "p2_new_root")):
        cols[nm] = _ints(tx[k])
    cols["sigSign"] = _flags(tx["sig_sign"])
    cols["P1.enabled"] = _flags(tx["p1_enabled"])
    cols["P2.enabled"] = _flags(tx["p2_enabled"])
    for s, k in _BAL_SIGNALS:
        cols[f"balance.{s}"] = _column(bal[k])
    acc = fr.to_numpy(lanes["acc_fee_out"])  # (F, 16, T)
    acc_cols = [_ints(acc[j]) for j in range(F)]
    cols["newStateRoot"] = _ints(lanes["new_state_root"])
    cols["newExitRoot"] = _ints(lanes["new_exit_root"])
    cols["isAmountNullified"] = _flags(lanes["is_amount_nullified"])

    for i in range(T):
        values.append(cols["decodeLoadAmount"][i])
        values += [cols[f"states.{s}"][i] for s, _ in _STATE_SIGNALS]
        values += [cols["decodeFromBjj.ay"][i],
                   cols["decodeFromBjj.sign"][i]]
        values += [cols[f"s1.{s}"][i] for s in _MUX_SIGNALS]
        values += [cols[f"s2.{s}"][i] for s in _MUX_SIGNALS]
        values += [cols["oldStHash1"][i], cols["oldStHash2"][i]]
        values += [cols["sigAy"][i], cols["sigSign"][i],
                   cols["sigAx"][i]]
        values += [cols[f"balance.{s}"][i] for s, _ in _BAL_SIGNALS]
        values += [acc_cols[j][i] for j in range(F)]
        values += [cols["newNonce1"][i], cols["newStHash1"][i],
                   cols["newStHash2"][i]]
        values += [cols["P1.enabled"][i], cols["P1.newRoot"][i],
                   cols["P2.enabled"][i], cols["P2.newRoot"][i]]
        values += [cols["newStateRoot"][i], cols["newExitRoot"][i],
                   cols["isAmountNullified"][i]]

    # ---- section FEE ----
    fee = out["fee"]
    f_old = _ints(fee["old_state_hash"])
    f_bal = _ints(fee["new_balance"])
    f_new = _ints(fee["new_state_hash"])
    f_root = _ints(fee["new_root"])
    for j in range(F):
        values += [f_old[j], f_bal[j], f_new[j], f_root[j]]

    # ---- section TAIL ----
    values.append(fr.unpack_int(out["new_last_idx"]))
    values.append(fr.unpack_int(out["new_state_root"]))
    values.append(fr.unpack_int(out["new_exit_root"]))
    values += _ints(out["acc_fee_out"].movedim(1, 0))  # (F, 16) -> (16, F)
    return values


# ---------------------------------------------------------------------------
# .wtns container (snarkjs binary witness format) + name sidecar
# ---------------------------------------------------------------------------

def write_wtns(path: str | Path, values: list[int]) -> int:
    """snarkjs .wtns v2 container: the handoff format snarkjs's prover
    reads (reference actions.js:139 writes the JSON twin). Returns the
    bytes written."""
    path = Path(path)
    n8 = 32
    sec1 = struct.pack("<I", n8) + P.to_bytes(32, "little") + \
        struct.pack("<I", len(values))
    # each value as (v % P).to_bytes(32, "little"), by the pack's C routine
    sec2 = bytearray(n8 * len(values))
    limbs.write(values, sec2, 0, False, fr.to_field)
    with path.open("wb") as f:
        f.write(b"wtns" + struct.pack("<II", 2, 2))
        f.write(struct.pack("<IQ", 1, len(sec1)) + sec1)
        f.write(struct.pack("<IQ", 2, len(sec2)))
        f.write(sec2)
    return 12 + 12 + len(sec1) + 12 + len(sec2)


def read_wtns(path: str | Path) -> list[int]:
    data = Path(path).read_bytes()
    assert data[:4] == b"wtns", "not a wtns file"
    _ver, n_sec = struct.unpack_from("<II", data, 4)
    off = 12
    values = []
    for _ in range(n_sec):
        sec_id, sec_len = struct.unpack_from("<IQ", data, off)
        off += 12
        body = data[off:off + sec_len]
        off += sec_len
        if sec_id == 1:
            n8 = struct.unpack_from("<I", body, 0)[0]
            assert int.from_bytes(body[4:4 + n8], "little") == P
        elif sec_id == 2:
            values = [int.from_bytes(body[k:k + 32], "little")
                      for k in range(0, len(body), 32)]
    return values


def write_sym(path: str | Path, names: list[str]) -> None:
    """Name sidecar (the .sym analogue): canonical name -> index."""
    Path(path).write_text(json.dumps(
        {n: i for i, n in enumerate(names)}, indent=0))


def load_witness(wtns_path: str | Path, sym_path: str | Path) \
        -> dict[str, int]:
    values = read_wtns(wtns_path)
    name_to_idx = json.loads(Path(sym_path).read_text())
    assert len(name_to_idx) == len(values)
    return {n: values[i] for n, i in name_to_idx.items()}


# ---------------------------------------------------------------------------
# Withdraw circuit (src/withdraw.circom:21-72)
# ---------------------------------------------------------------------------

_WD_INPUTS = ["rootExit", "ethAddr", "tokenID", "balance", "idx", "sign",
              "ay"]


def signal_names_withdraw(n_levels: int, n_lanes: int) -> list[str]:
    """Canonical ordering for a batch of Withdraw(nLevels) instances."""
    L = n_levels + 1
    names = ["one"]
    names += [f"main.hashGlobalInputs[{w}]" for w in range(n_lanes)]
    for w in range(n_lanes):
        names += [f"main.{k}[{w}]" for k in _WD_INPUTS]
        names += [f"main.siblingsState[{w}][{k}]" for k in range(L)]
    names += [f"main.stateHash[{w}]" for w in range(n_lanes)]
    return names


def export_witness_withdraw(engine, inputs: list[dict]) \
        -> tuple[list[str], list[int]]:
    """Full witness vector for a batch of withdrawal lanes. `engine` is
    a WithdrawEngine; `inputs` as WithdrawEngine.run takes them."""
    n_levels = engine.n_levels
    L = n_levels + 1
    h_vals, ok, dbg = engine.run_debug(inputs)
    assert bool(ok.all()), "invalid withdraw witness"
    values: list[int] = [1]
    values += h_vals
    for d in inputs:
        for k in _WD_INPUTS:
            values.append(int(d[k]))
        sibs = list(d["siblingsState"])
        values += [int(s) for s in sibs] + [0] * (L - len(sibs))
    values += _ints(dbg["state_hash"])
    names = signal_names_withdraw(n_levels, len(inputs))
    assert len(names) == len(values)
    return names, values
