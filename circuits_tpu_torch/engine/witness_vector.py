"""Full witness vector export — the prover handoff artifact.

Port of `circuits_tpu/engine/witness_vector.py`. The reference's native
witness calculator writes every circuit signal to `witness.json` / `.wtns`,
which snarkjs consumes for Groth16 proving (tools/helpers/actions.js:
132-146, :168-185). This module is that artifact for this engine: a
COMPLETE, canonically-ordered, signal-indexed vector of every value the
monomorphized circuit evaluates. The names, the order and the container
bytes are the JAX package's. The vector is built on the device as the
bytes of the `.wtns`'s section 2: every value already lies there as 16
canonical 16-bit limbs (section IN in the packed input, reduced mod P by
the pack; the rest in the debug graph's outputs), and 16 limbs read as
little-endian uint16 are the value's 32 little-endian bytes. One gather
by a layout built once for the parameters (`_Layout`) puts them in order,
and one copy brings them to the host, into a page-locked buffer on a card.

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
whatever the verdict, its bytes read as ints (so every value mod P).
Spans (`spans.py`): `export.handoff` around a handoff; `export.evaluate`
the pack and the debug graph up to the verdict; `export.read` the gather
on the device and the one copy to the host (`_vector`; counters
`export_values`, the vector's values, and `export_device_values`, the
rows the device's gather gave); `export.write` the file, written from the
host buffer (`write_wtns`; counter `wtns_bytes`).
"""

from __future__ import annotations

import json
import math
import struct
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

from .. import spans
from ..field import fr, limbs
from ..field.scalar import P
from ..models.decode_tx import L1_TX_FULL_BITS, l1l2_bits
from .witness import _snake, staging

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


# ---------------------------------------------------------------------------
# The vector as bytes on the device
# ---------------------------------------------------------------------------

# a word's limbs mod P: P's low 64 bits, and its limbs 4-15 (limb 4 is not
# zero, so the borrow of p + v for a negative int64 v stops there)
_P_LO = P & (2**64 - 1)
_P_HIGH = [(P >> (16 * k)) & fr.MASK for k in range(4, fr.N_LIMBS)]
assert _P_HIGH[0] > 0


class _Layout:
    """Where each value of the vector comes from: the source matrix of one
    evaluation, (rows, 16) int16 limbs, and `index`, the row of each value
    in `signal_names` order, so that the matrix's rows gathered by `index`
    are section 2 of the `.wtns`, each row a value's 32 little-endian bytes.

    The matrix's rows are the field tensors' values (a tensor's limb axis
    moved last, its other axes flattened in order), then one row a word:
    the flags and bits of the input and of the evaluation, and the constant
    1, each written as its value mod P. `fields` and `words` list the
    sources as (tree, path, limb axis, first row, end row) and (tree, path,
    first word, end word), read from the trees of one evaluation: "packed"
    (the packed input dict, section IN reduced mod P by the pack), "lanes"
    and "out" (the debug graph's outputs) and "one". Built once for each
    engine's parameters and device (`_layout`), from the section structure
    below, with numpy over the sources, not over the values."""

    def __init__(self, params, trees: dict, device: torch.device):
        self.fields, self.words = [], []
        self.field_rows = self.word_rows = 0
        index = self._walk(params, trees)
        # words after the fields: a word's id w (negative) is row -w - 1
        index = np.where(index < 0, self.field_rows - index - 1, index)
        self.values = len(index)
        self.index = torch.from_numpy(index).to(device)

    @staticmethod
    def _get(trees, tree, path):
        t = trees[tree]
        for p in path:
            t = t[p]
        return t

    def _field(self, trees, tree, *path, axis=0) -> np.ndarray:
        """Register a field tensor; its rows' ids, shaped as its other
        axes (the lane axis last)."""
        shape = list(self._get(trees, tree, path).shape)
        del shape[axis]
        n = math.prod(shape)
        lo = self.field_rows
        self.fields.append((tree, path, axis, lo, lo + n))
        self.field_rows += n
        return np.arange(lo, lo + n, dtype=np.int64).reshape(shape)

    def _word(self, trees, tree, *path) -> np.ndarray:
        """Register a flag or bit tensor; its words' ids (negative), shaped
        as it is."""
        shape = self._get(trees, tree, path).shape
        n = math.prod(shape)
        lo = self.word_rows
        self.words.append((tree, path, lo, lo + n))
        self.word_rows += n
        return -1 - np.arange(lo, lo + n, dtype=np.int64).reshape(shape)

    def _lane(self, trees, tree, *path) -> np.ndarray:
        """A per-lane signal, a field (16, B) or a flag (B,): (1, B) ids."""
        t = self._get(trees, tree, path)
        ids = self._field(trees, tree, *path) if t.dim() == 2 \
            else self._word(trees, tree, *path)
        return ids.reshape(1, -1)

    def _walk(self, params, trees) -> np.ndarray:
        def lane_major(rows):
            """(m_k, B) id blocks, one a signal -> the lane-major order."""
            return np.concatenate(rows).T.reshape(-1)

        def field(*path, axis=0):
            return self._field(trees, *path, axis=axis)

        def lane(*path):
            return self._lane(trees, *path)

        parts = [self._word(trees, "one"),
                 field("out", "hash_global_inputs").reshape(-1)]

        # ---- section IN: the packed input dict ----
        for k in ("oldLastIdx", "oldStateRoot", "globalChainID",
                  "currentNumBatch", "feeIdxs", "feePlanTokens"):
            parts.append(field("packed", _snake(k)).reshape(-1))
        parts.append(self._word(trees, "packed", "im_on_chain"))
        for k in ("imOutIdx", "imStateRoot", "imExitRoot"):
            parts.append(field("packed", _snake(k)))
        # (F, T - 1) -> lane i's F slots, lane by lane
        parts.append(field("packed", "im_acc_fee_out", axis=1).T.reshape(-1))
        for k in ("imStateRootFee", "imInitStateRootFee", "imFinalAccFee"):
            parts.append(field("packed", _snake(k)).reshape(-1))
        for inputs in (_TX_INPUTS, _FEE_INPUTS):
            rows = []
            for name, kind in inputs:
                key = _snake(name)
                if kind == "field":
                    rows.append(field("packed", key).reshape(1, -1))
                elif kind == "siblings":
                    rows.append(field("packed", key, axis=1))
                else:  # flag (B,), bits256 (256, T)
                    rows.append(self._word(trees, "packed", key).reshape(
                        -1, trees["packed"][key].shape[-1]))
            parts.append(lane_major(rows))

        # ---- section DEC ----
        rows = [lane("lanes", "decode", k) for _, k in _DEC_SIGNALS]
        rows += [self._word(trees, "lanes", "decode", k)
                 for k in ("l1l2_tx_data", "l1_tx_full_data")]
        parts.append(lane_major(rows))

        # ---- section TX ----
        rows = [lane("lanes", "tx", "balance", "load_amount")]
        rows += [lane("lanes", "tx", "states", k) for _, k in _STATE_SIGNALS]
        rows += [lane("lanes", "tx", "decode_ay"),
                 lane("lanes", "tx", "decode_sign")]
        for side in ("s1", "s2"):
            rows += [lane("lanes", "tx", side, k) for k in _MUX_KEYS]
        rows += [lane("lanes", "tx", k) for k in (
            "old_state_hash1", "old_state_hash2", "sig_ay", "sig_sign",
            "sig_ax")]
        rows += [lane("lanes", "tx", "balance", k) for _, k in _BAL_SIGNALS]
        rows.append(field("lanes", "acc_fee_out", axis=1))  # (F, T)
        rows += [lane("lanes", "tx", k) for k in (
            "new_nonce1", "new_state_hash1", "new_state_hash2",
            "p1_enabled", "p1_new_root", "p2_enabled", "p2_new_root")]
        rows += [lane("lanes", k) for k in (
            "new_state_root", "new_exit_root", "is_amount_nullified")]
        parts.append(lane_major(rows))

        # ---- section FEE ----
        parts.append(lane_major([lane("out", "fee", k) for k in (
            "old_state_hash", "new_balance", "new_state_hash", "new_root")]))

        # ---- section TAIL ----
        for k in ("new_last_idx", "new_state_root", "new_exit_root"):
            parts.append(field("out", k).reshape(-1))
        parts.append(field("out", "acc_fee_out", axis=1).reshape(-1))
        index = np.concatenate(parts)
        assert len(index) == len(signal_names(*params))
        return index

    def section(self, trees: dict) -> torch.Tensor:
        """Section 2 of one evaluation, on its device: every value's 32
        little-endian bytes in `signal_names` order, (values * 32,)
        uint8."""
        dev = self.index.device
        src = torch.empty(self.field_rows + self.word_rows, fr.N_LIMBS,
                          dtype=torch.int16, device=dev)
        # canonical limbs lie in [0, 2^16): the cast to int16 keeps their
        # 16 bits, which read as uint16 are the value's bytes
        for tree, path, axis, lo, hi in self.fields:
            t = self._get(trees, tree, path).movedim(axis, -1)
            src[lo:hi].view(t.shape).copy_(t)
        words = torch.empty(self.word_rows, dtype=torch.int64, device=dev)
        for tree, path, lo, hi in self.words:
            t = self._get(trees, tree, path)
            words[lo:hi].view(t.shape).copy_(t)
        _words_mod_p(words, src[self.field_rows:])
        return src.index_select(0, self.index).view(torch.uint8).view(-1)


def _words_mod_p(words: torch.Tensor, rows: torch.Tensor) -> None:
    """int64 words (n,) -> their values mod P as limbs into `rows` (n, 16):
    v itself where v >= 0; else P + v, whose low 64 bits are d = P_lo + v
    (two's complement, negative where the borrow reaches limb 4) and whose
    limbs above are P's."""
    dev = words.device
    neg = words < 0
    d = words + neg * _P_LO
    rows[:, :4].copy_((d.unsqueeze(1) >> fr._col((0, 16, 32, 48), 1, dev))
                      & fr.MASK)
    high = neg.unsqueeze(1) * fr._col(_P_HIGH, 1, dev)
    high[:, 0] -= (d < 0).long()
    rows[:, 4:].copy_(high)


# (params, device) -> its layout, made at the first evaluation read
_LAYOUTS: dict[tuple, _Layout] = {}


def _layout(engine, trees: dict) -> _Layout:
    key = (engine.params, engine.device)
    if key not in _LAYOUTS:
        _LAYOUTS[key] = _Layout(engine.params, trees, engine.device)
    return _LAYOUTS[key]


def _trees(engine, packed: dict, lanes: dict, out: dict) -> dict:
    """The trees of one evaluation that the layout reads."""
    one = torch.ones(1, dtype=torch.int64, device=engine.device)
    return dict(packed=packed, lanes=lanes, out=out, one=one)


def _evaluate(engine, inp: dict):
    """One debug evaluation of the whole circuit through the engine's
    captured `debug_call`, on the input packed once: (packed, lanes, out,
    ok), the packed dict, the graph's outputs and the verdict read back."""
    with spans.span("export.evaluate"):
        packed = engine.pack(inp)
        lanes, _lane_ok, out, ok = engine.debug_call(packed)[:4]
        return packed, lanes, out, bool(ok)


def _stage(engine, layout: _Layout):
    """The page-locked buffer of the vector's bytes on the engine's card
    (`witness.staging`, one a size); None on the CPU."""
    if engine.device.type == "cpu":
        return None
    return staging(engine.device, 32 * layout.values)


@contextmanager
def _held(engine, packed: dict, lanes: dict, out: dict):
    """Hold the buffer `_vector` copies into for the block, so that the
    vector it returns stays as read until the block ends."""
    stage = _stage(engine, _layout(engine, _trees(engine, packed, lanes,
                                                  out)))
    with stage.lock if stage else nullcontext():
        yield


class _Vector:
    """The vector of one evaluation on the host as section 2 of its
    `.wtns`: `body`, (values * 32,) uint8, each value's 32 little-endian
    bytes, on a card the page-locked buffer (valid while `_held`). It reads
    as the sequence of the values, an int made only where one is read; an
    item set writes the value mod P."""

    def __init__(self, body: np.ndarray):
        self.body = body

    def __len__(self) -> int:
        return len(self.body) // 32

    def _rows(self, k) -> np.ndarray:
        return self.body.reshape(-1, 32)[k]

    def __getitem__(self, k):
        if isinstance(k, slice):
            return limbs.read(np.ascontiguousarray(self._rows(k)))
        return int.from_bytes(self._rows(k).tobytes(), "little")

    def __setitem__(self, k: int, v: int) -> None:
        self._rows(k)[:] = np.frombuffer(
            fr.to_field(v).to_bytes(32, "little"), dtype=np.uint8)

    def __iter__(self):
        return iter(limbs.read(self.body))


def _vector(engine, packed: dict, lanes: dict, out: dict) -> _Vector:
    """The vector of one evaluation, gathered on the device as section 2's
    bytes (`_Layout.section`) and, from a card, copied once into the
    page-locked buffer of its size, which the caller holds (`_held`)."""
    trees = _trees(engine, packed, lanes, out)
    layout = _layout(engine, trees)
    stage = _stage(engine, layout)
    with spans.span("export.read"):
        body = layout.section(trees)
        if stage is None:
            host = body.numpy()
        else:
            stage.copied.synchronize()
            stage.host.copy_(body, non_blocking=True)
            stage.copied.record(torch.cuda.current_stream(engine.device))
            stage.copied.synchronize()
            host = stage.host.numpy()
        spans.count("export_values", layout.values)
        spans.count("export_device_values", body.numel() // 32)
    return _Vector(host)


def export_witness(engine, inp: dict) -> tuple[list[str], list[int]]:
    """Evaluate the full witness for a builder/JSON input dict.

    Returns (names, values) in canonical order, whatever the verdict.
    `engine` is a RollupEngine; one debug evaluation computes every
    signal, and the handoff's bytes are read back as ints, so every value
    is in [0, P): an input given as v + p or as a negative int comes back
    as v mod P (the JAX package returns section IN as given)."""
    packed, lanes, out, _ = _evaluate(engine, inp)
    with _held(engine, packed, lanes, out):
        values = list(_vector(engine, packed, lanes, out))
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
    from the bytes written."""
    with spans.span("export.handoff"):
        packed, lanes, out, ok = _evaluate(engine, inp)
        if not ok:
            return None, False
        with _held(engine, packed, lanes, out):
            values = _vector(engine, packed, lanes, out)
            with spans.span("export.write"):
                spans.count("wtns_bytes", write_wtns(path, values))
            F = engine.params[3]
            tail = values[-(F + 3):]
            return dict(hash_global_inputs=values[1],
                        new_state_root=tail[1], new_exit_root=tail[2],
                        new_last_idx=tail[0], acc_fee_out=tail[3:]), True


# ---------------------------------------------------------------------------
# .wtns container (snarkjs binary witness format) + name sidecar
# ---------------------------------------------------------------------------

def _write_section(path: str | Path, body) -> int:
    """The snarkjs .wtns v2 container around `body`, section 2 as it is
    written (32 little-endian bytes a value, below P): the header, then the
    body from its own memory. Returns the bytes written."""
    n8 = 32
    sec1 = struct.pack("<I", n8) + P.to_bytes(32, "little") + \
        struct.pack("<I", len(body) // n8)
    head = b"wtns" + struct.pack("<II", 2, 2) + \
        struct.pack("<IQ", 1, len(sec1)) + sec1 + \
        struct.pack("<IQ", 2, len(body))
    with Path(path).open("wb") as f:
        f.write(head)
        f.write(body)
    return len(head) + len(body)


def write_wtns(path: str | Path, values) -> int:
    """snarkjs .wtns v2 container: the handoff format snarkjs's prover
    reads (reference actions.js:139 writes the JSON twin). `values` is a
    list of ints, or a `_Vector`, whose bytes are written as they lie.
    Returns the bytes written."""
    if isinstance(values, _Vector):
        return _write_section(path, values.body)
    # each value as (v % P).to_bytes(32, "little"), by the pack's C routine
    sec2 = bytearray(32 * len(values))
    limbs.write(values, sec2, 0, False, fr.to_field)
    return _write_section(path, sec2)


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
