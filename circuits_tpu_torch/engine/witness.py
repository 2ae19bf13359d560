"""Input packing + witness evaluation for the top-level circuits.

Port of `circuits_tpu/engine/witness.py`: builder input dict (Python ints,
camelCase keys of the circom input JSON) -> packed int64 limb tensors with
the tx (or withdrawal) lane as batch axis -> one evaluation that returns
the public outputs and a validity verdict. `RollupEngine` evaluates
RollupMain and reads its signals by name (`trace`, `get_signal`);
`WithdrawEngine` evaluates a batch of Withdraw instances. The entry points
run on the card ("cuda") unless the caller names another device, and raise
where there is no card; they never carry on on the CPU by themselves. A
caller who passes `device="cpu"` (the tests) gets the plain PyTorch
versions.

An engine's `run_packed` goes through its `CapturedCall` (`engine/aot.py`),
the counterpart of the JAX engines' `jax.jit`, once per input shape: the
first batch of a shape runs op by op, the second captures the circuit as a
CUDA graph and replays it, later batches replay it (`compile()` captures
ahead instead). A capture or replay that fails raises; nothing falls back
to the eager path. On the CPU the same bookkeeping runs the plain calls.
`run_packed_eager` runs the circuit op by op, for debugging and for
callers that watch the Python kernel wrappers, which a replay never calls.
The debug routes are compiled the same way, as the JAX engines jit them:
`trace` / `get_signal` (`RollupEngine.trace_call`), `_full_debug`
(`debug_call`, the witness-vector export) and `WithdrawEngine.run_debug`
(`debug_call_for`); `_trace_lanes_eager`, `_full_debug_eager` and
`run_packed_eager(debug=True)` are their op-by-op routes. An engine's
graphs share one memory pool (`aot.graph_pool` says why that is safe).

A pack runs in two stages, a producer and a consumer: on the host each
value becomes a numpy array (limbs by `fr.pack_np`, flags, bits), and each
array is copied to the device as soon as it is made, where the limb tables
are then permuted to their lane-last layout. The engines record their
spans (`spans.py`): `witness.run` around `run`, `witness.pack` around the
pack with a child `witness.pack.h2d` around each copy to a device other
than the CPU (counter `h2d_bytes`), and `witness.unpack` around
`unpack_outputs`.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import spans
from ..field import fr
from .aot import (CapturedCall, graph_pool, rollup_input_shapes,
                  withdraw_input_shapes)
from ..models.rollup_main import (build_chains, global_tail, rollup_main,
                                  rollup_main_lanes)
from ..models.withdraw import withdraw

_SCALARS = ["oldLastIdx", "oldStateRoot", "globalChainID",
            "currentNumBatch", "imInitStateRootFee"]
_PER_TX_FIELD = [
    "txCompressedData", "amountF", "txCompressedDataV2", "fromIdx",
    "auxFromIdx", "toIdx", "auxToIdx", "toBjjAy", "toEthAddr",
    "maxNumBatch", "rqTxCompressedDataV2", "rqToEthAddr", "rqToBjjAy",
    "s", "r8x", "r8y", "loadAmountF", "fromEthAddr",
    "tokenID1", "nonce1", "balance1", "ay1", "ethAddr1", "oldKey1",
    "oldValue1",
    "tokenID2", "nonce2", "balance2", "ay2", "ethAddr2", "oldKey2",
    "oldValue2",
]
_PER_TX_FLAG = ["onChain", "newAccount", "newExit", "isOld0_1", "isOld0_2",
                "sign1", "sign2", "rqOffset"]
_PER_FEE_FIELD = ["feePlanTokens", "feeIdxs", "imFinalAccFee", "tokenID3",
                  "nonce3", "balance3", "ay3", "ethAddr3"]
_IM_FIELD = {"imOutIdx": "im_out_idx", "imStateRoot": "im_state_root",
             "imExitRoot": "im_exit_root",
             "imStateRootFee": "im_state_root_fee"}


def _snake(name: str) -> str:
    """camelCase builder key -> snake_case tensor key (oldKey1 ->
    old_key1, isOld0_1 -> is_old0_1, globalChainID -> global_chain_id)."""
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0 and not name[i - 1].isupper():
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises where it names a CUDA device and
    there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device=\"cpu\" to run the plain versions")
    return dev


def _limbs(values) -> np.ndarray:
    return fr.pack_np(values).astype(np.int64)


def _flags(vals) -> np.ndarray:
    return np.array([int(v) for v in vals], dtype=np.int64)


# limb tables packed (16, n, m) on the host and permuted on the device to
# (m, 16, n): siblings (T, L+1) -> (L+1, 16, T), imAccFeeOut (T-1, F) ->
# (F, 16, T-1)
_LANE_LAST = ("siblings1", "siblings2", "siblings3", "siblings_state",
              "im_acc_fee_out")


def _to_device(arrays, device: torch.device) -> dict:
    """The pack's second stage: each (key, host array) of the first onto
    `device` as it comes, in its dtype and shape, then the `_LANE_LAST`
    tables permuted there. Copying each array while it is fresh lets the
    host reuse its memory for the next; holding them all first costs a
    fault on every new page, each call (16 ms of a RollupMain(2048, ...)
    pack)."""
    out = {}
    for k, a in arrays:
        if device.type == "cpu":
            out[k] = torch.from_numpy(a)
            continue
        with spans.span("witness.pack.h2d"):
            out[k] = torch.from_numpy(a).to(device)
            spans.count("h2d_bytes", a.nbytes)
    for k in _LANE_LAST:
        if k in out:
            out[k] = out[k].permute(2, 0, 1).contiguous()
    return out


def _rollup_host(inp: dict, max_fee_tx: int):
    """The pack's first stage for RollupMain: (key, numpy int64 array),
    one at a time."""
    for k in _SCALARS:
        yield _snake(k), _limbs([inp[k]])
    for k in _PER_TX_FIELD + _PER_FEE_FIELD:
        yield _snake(k), _limbs(inp[k])
    for k in _PER_TX_FLAG:
        yield _snake(k), _flags(inp[k])
    yield "sign3", _flags(inp["sign3"])
    # bits: (T, 256) LSB-first lists -> (256, T)
    bjj = np.array(inp["fromBjjCompressed"], dtype=np.int64).reshape(-1, 256)
    yield "from_bjj_compressed", np.ascontiguousarray(bjj.T)
    for k in ("siblings1", "siblings2", "siblings3"):
        yield k, _limbs(inp[k])
    yield "im_on_chain", _flags(inp["imOnChain"])
    for k, name in _IM_FIELD.items():
        yield name, _limbs(inp[k])
    acc = _limbs(inp["imAccFeeOut"])
    if acc.ndim == 2:  # T = 1: an empty chain
        acc = acc.reshape(16, 0, max_fee_tx)
    yield "im_acc_fee_out", acc


def pack_rollup_inputs(inp: dict, n_tx: int, n_levels: int,
                       max_l1_tx: int, max_fee_tx: int,
                       device="cuda") -> dict:
    """Builder/JSON input dict -> the models' tensors on `device`."""
    device = resolve_device(device)
    with spans.span("witness.pack"):
        return _to_device(_rollup_host(inp, max_fee_tx), device)


_WITHDRAW_FIELD = {"rootExit": "root_exit", "ethAddr": "eth_addr",
                   "tokenID": "token_id", "balance": "balance", "idx": "idx",
                   "ay": "ay"}


def pack_withdraw_inputs(inputs: list[dict], n_levels: int,
                         device="cuda") -> dict:
    """Withdraw input dicts (rootExit, ethAddr, tokenID, balance, idx, sign,
    ay, siblingsState), one a lane -> the keyword arguments of
    `models.withdraw.withdraw` on `device`. A value given as a string is
    read with its base prefix (the builder's hex strings); siblingsState is
    padded with zeros to nLevels + 1."""
    device = resolve_device(device)
    levels = n_levels + 1

    def value(v):
        return int(str(v), 0) if isinstance(v, str) else int(v)

    def host():
        for k, name in _WITHDRAW_FIELD.items():
            yield name, _limbs([value(d[k]) for d in inputs])
        yield "sign", _flags([d["sign"] for d in inputs])
        rows = []
        for d in inputs:
            sib = list(d["siblingsState"])
            rows.append(sib + [0] * (levels - len(sib)))
        yield "siblings_state", _limbs(rows)

    with spans.span("witness.pack"):
        return _to_device(host(), device)


class RollupEngine:
    """RollupMain(nTx, nLevels, maxL1Tx, maxFeeTx) witness engine on one
    device."""

    def __init__(self, n_tx, n_levels, max_l1_tx, max_fee_tx,
                 device="cuda"):
        self.params = (n_tx, n_levels, max_l1_tx, max_fee_tx)
        self.device = resolve_device(device)
        # the compiled circuit and its two debug routes, on the same input
        # shapes, in one memory pool: a call clones its outputs before any
        # other replays, and the static inputs lie outside the pool
        self._pool = graph_pool(self.device)
        shapes = rollup_input_shapes(*self.params)
        self.call = CapturedCall(self.run_packed_eager, shapes,
                                 self.device, pool=self._pool,
                                 route="rollup")
        self.trace_call = CapturedCall(self._trace_lanes_eager, shapes,
                                       self.device, pool=self._pool,
                                       route="rollup.trace")
        self.debug_call = CapturedCall(self._full_debug_eager, shapes,
                                       self.device, pool=self._pool,
                                       route="rollup.debug")

    def pack(self, inp: dict) -> dict:
        return pack_rollup_inputs(inp, *self.params, device=self.device)

    def compile(self) -> CapturedCall:
        """Capture RollupMain at this engine's shapes now (once), not at the
        second `run_packed`, and return the compiled call."""
        if self.call.outputs is None:
            self.call.capture()
        return self.call

    def run_packed(self, packed: dict):
        """Packed tensors -> (outputs dict of tensors, ok 0-d tensor),
        through the compiled circuit."""
        return self.call(packed)

    def run_packed_eager(self, packed: dict):
        """`run_packed` op by op: every kernel wrapper called from Python."""
        n_tx, n_levels, max_l1_tx, max_fee_tx = self.params
        return rollup_main(packed, n_tx=n_tx, n_levels=n_levels,
                           max_l1_tx=max_l1_tx, max_fee_tx=max_fee_tx)

    def run(self, inp: dict):
        """inp: builder input dict. Returns (outputs dict of host ints,
        ok bool)."""
        with spans.span("witness.run"):
            out, ok = self.run_packed(self.pack(inp))
            return self.unpack_outputs(out), bool(ok)

    @staticmethod
    def unpack_outputs(out: dict) -> dict:
        with spans.span("witness.unpack"):
            res = {k: fr.unpack_int(out[k]) for k in
                   ("hash_global_inputs", "new_state_root", "new_exit_root",
                    "new_last_idx")}
            res["acc_fee_out"] = [int(v) for v in fr.unpack_np(
                out["acc_fee_out"].movedim(1, 0))]
            return res

    # Signal catalog: dotted trace name -> (group path in the debug lane
    # dict, circom signal it mirrors). The trace()/get_signal() pair is
    # the printSignals equivalent (reference
    # test/helpers/helpers.js:168-188) -- every name reads the value the
    # corresponding circom signal would hold, per tx lane.
    SIGNALS = {
        # DecodeTx (src/decode-tx.circom)
        "decode.fromIdx": (("decode", "from_idx"), "Decoder[i].fromIdx"),
        "decode.toIdx": (("decode", "to_idx"), "Decoder[i].toIdx"),
        "decode.tokenID": (("decode", "token_id"), "Decoder[i].tokenID"),
        "decode.nonce": (("decode", "nonce"), "Decoder[i].nonce"),
        "decode.userFee": (("decode", "user_fee"), "Decoder[i].userFee"),
        "decode.amount": (("decode", "amount"), "Decoder[i].amount"),
        "decode.toBjjSign": (("decode", "to_bjj_sign"),
                             "Decoder[i].toBjjSign"),
        "decode.sigL2Hash": (("decode", "sig_l2_hash"),
                             "Decoder[i].sigL2Hash"),
        "decode.newAccountIdx": (("decode", "out_idx"),
                                 "Decoder[i].outIdx"),
        "decode.txCompressedDataV2": (("decode", "tx_compressed_data_v2"),
                                      "Decoder[i].txCompressedDataV2"),
        # RollupTxStates (src/rollup-tx-states.circom)
        "states.key1": (("tx", "states", "key1"), "Tx[i].states.key1"),
        "states.key2": (("tx", "states", "key2"), "Tx[i].states.key2"),
        "states.P1_fnc0": (("tx", "states", "p1_fnc0"),
                           "Tx[i].states.P1_fnc0"),
        "states.P1_fnc1": (("tx", "states", "p1_fnc1"),
                           "Tx[i].states.P1_fnc1"),
        "states.P2_fnc0": (("tx", "states", "p2_fnc0"),
                           "Tx[i].states.P2_fnc0"),
        "states.P2_fnc1": (("tx", "states", "p2_fnc1"),
                           "Tx[i].states.P2_fnc1"),
        "states.isExit": (("tx", "states", "is_exit"),
                          "Tx[i].states.isExit"),
        "states.verifySignEnabled": (("tx", "states",
                                      "verify_sign_enabled"),
                                     "Tx[i].states.verifySignEnabled"),
        "states.nullifyLoadAmount": (("tx", "states",
                                      "nullify_load_amount"),
                                     "Tx[i].states.nullifyLoadAmount"),
        "states.nullifyAmount": (("tx", "states", "nullify_amount"),
                                 "Tx[i].states.nullifyAmount"),
        # BalanceUpdater (src/balance-updater.circom)
        "balanceUpdater.newStBalanceSender": (
            ("tx", "balance", "new_balance_sender"),
            "Tx[i].balancesUpdater.newStBalanceSender"),
        "balanceUpdater.newStBalanceReceiver": (
            ("tx", "balance", "new_balance_receiver"),
            "Tx[i].balancesUpdater.newStBalanceReceiver"),
        "balanceUpdater.fee2Charge": (("tx", "balance", "fee2_charge"),
                                      "Tx[i].balancesUpdater.fee2Charge"),
        "balanceUpdater.isP2Nop": (("tx", "balance", "is_p2_nop"),
                                   "Tx[i].balancesUpdater.isP2Nop"),
        "balanceUpdater.isAmountNullified": (
            ("tx", "balance", "is_amount_nullified"),
            "Tx[i].balancesUpdater.isAmountNullified"),
        "decodeLoadAmount": (("tx", "balance", "load_amount"),
                             "Tx[i].decodeLoadAmountF.out"),
        # HashState instances (src/lib/hash-state.circom)
        "oldStHash1": (("tx", "old_state_hash1"), "Tx[i].oldStHash1.out"),
        "oldStHash2": (("tx", "old_state_hash2"), "Tx[i].oldStHash2.out"),
        "newStHash1": (("tx", "new_state_hash1"), "Tx[i].newStHash1.out"),
        "newStHash2": (("tx", "new_state_hash2"), "Tx[i].newStHash2.out"),
        # EdDSA / SMT (src/rollup-tx.circom phases F, J)
        "sigAx": (("tx", "sig_ax"), "Tx[i].getAx.ax"),
        "processor1.newRoot": (("tx", "p1_new_root"),
                               "Tx[i].processor1.newRoot"),
        "processor2.newRoot": (("tx", "p2_new_root"),
                               "Tx[i].processor2.newRoot"),
        # lane outputs
        "newStateRoot": (("new_state_root",), "Tx[i].newStateRoot"),
        "newExitRoot": (("new_exit_root",), "Tx[i].newExitRoot"),
        "outIdx": (("out_idx",), "Decoder[i].outIdx"),
        "isAmountNullified": (("is_amount_nullified",),
                              "Tx[i].isAmountNullified"),
    }

    def _trace_lanes(self, inp: dict):
        """The lane phases with every intermediate kept: (lanes debug dict,
        lane_ok (T,)), through the compiled `trace_call`."""
        return self.trace_call(self.pack(inp))

    def _trace_lanes_eager(self, packed: dict):
        """`_trace_lanes` op by op on packed tensors."""
        n_tx, n_levels, _, max_fee_tx = self.params
        chains = build_chains(packed, n_tx, max_fee_tx)
        return rollup_main_lanes(packed, chains, n_tx, n_levels, max_fee_tx,
                                 debug=True)

    def _full_debug(self, inp: dict):
        """One debug evaluation of the WHOLE circuit (lanes + fee phase +
        global hash) with every intermediate kept -- the witness-vector
        export path (engine/witness_vector.py), through the compiled
        `debug_call`. Returns (lanes, lane_ok, outputs, ok)."""
        return self.debug_call(self.pack(inp))

    def _full_debug_eager(self, packed: dict):
        """`_full_debug` op by op on packed tensors."""
        n_tx, n_levels, max_l1_tx, max_fee_tx = self.params
        lanes, lane_ok = self._trace_lanes_eager(packed)
        out, tail_ok = global_tail(packed, lanes, n_tx, n_levels, max_l1_tx,
                                   max_fee_tx, debug=True)
        ok = lane_ok.all() & tail_ok & (packed["im_on_chain"] <= 1).all()
        return lanes, lane_ok, out, ok

    @staticmethod
    def _lookup(lanes: dict, path: tuple):
        v = lanes
        for p in path:
            v = v[p]
        return v

    @staticmethod
    def _to_host(arr) -> list:
        """One signal's tensor -> per-lane list of host ints. A field
        signal is (16, T) limbs and a flag signal (T,); both may be int64
        here, so the number of axes tells them apart, not the leading size
        (a flag over 16 lanes is (16,) too)."""
        a = fr.to_numpy(arr)
        if a.ndim == 2:
            return [int(v) for v in fr.unpack_np(a)]
        return [int(v) for v in a.reshape(-1)]

    def trace(self, inp: dict) -> dict:
        """Signal-level introspection (the printSignals equivalent,
        reference test/helpers/helpers.js:168-188): every SIGNALS entry
        as a per-lane list of host ints, plus lane_ok / accFeeOut."""
        lanes, lane_ok = self._trace_lanes(inp)
        res = {"lane_ok": fr.to_numpy(lane_ok).tolist()}
        for name, (path, _) in self.SIGNALS.items():
            res[name] = self._to_host(self._lookup(lanes, path))
        acc = fr.to_numpy(lanes["acc_fee_out"])  # (F, 16, T)
        res["accFeeOut"] = [self._to_host(acc[f])
                            for f in range(acc.shape[0])]
        return res

    def get_signal(self, inp: dict, name: str):
        """Read one named signal for every tx lane. `name` is a SIGNALS
        key, optionally suffixed "[i]" for a single lane
        (e.g. "states.key1[2]")."""
        lane = None
        if name.endswith("]") and "[" in name:
            base, idx = name[:-1].rsplit("[", 1)
            lane, name = int(idx), base
        if name not in self.SIGNALS:
            raise KeyError(
                f"unknown signal {name!r}; catalog: {sorted(self.SIGNALS)}")
        lanes, _ = self._trace_lanes(inp)
        vals = self._to_host(self._lookup(lanes, self.SIGNALS[name][0]))
        return vals if lane is None else vals[lane]


class WithdrawEngine:
    """Withdraw(nLevels) witness engine on one device, batched over
    withdrawal lanes."""

    def __init__(self, n_levels, device="cuda"):
        self.n_levels = n_levels
        self.device = resolve_device(device)
        # lanes -> the compiled circuit at that batch width, and its debug
        # route; all of them capture into one memory pool (see
        # `aot.graph_pool`)
        self.calls: dict[int, CapturedCall] = {}
        self.debug_calls: dict[int, CapturedCall] = {}
        self._pool = graph_pool(self.device)

    def pack(self, inputs: list[dict]) -> dict:
        return pack_withdraw_inputs(inputs, self.n_levels, self.device)

    def call_for(self, lanes: int) -> CapturedCall:
        """The compiled circuit of `lanes` withdrawals (made at first use,
        not yet captured)."""
        if lanes not in self.calls:
            self.calls[lanes] = CapturedCall(
                self.run_packed_eager,
                withdraw_input_shapes(self.n_levels, lanes), self.device,
                pool=self._pool, route="withdraw")
        return self.calls[lanes]

    def debug_call_for(self, lanes: int) -> CapturedCall:
        """The compiled debug route of `lanes` withdrawals
        (`run_packed_eager(debug=True)`), made at first use."""
        if lanes not in self.debug_calls:
            self.debug_calls[lanes] = CapturedCall(
                partial(self.run_packed_eager, debug=True),
                withdraw_input_shapes(self.n_levels, lanes), self.device,
                pool=self._pool, route="withdraw.debug")
        return self.debug_calls[lanes]

    def compile(self, lanes: int) -> CapturedCall:
        """Capture Withdraw at `lanes` withdrawals now (once per width), not
        at the second `run_packed` of that width, and return the compiled
        call."""
        call = self.call_for(lanes)
        if call.outputs is None:
            call.capture()
        return call

    def run_packed(self, packed: dict):
        """Packed tensors -> (hash (16, B), ok (B,) bool) tensors, through
        the compiled circuit of B lanes."""
        return self.call_for(packed["root_exit"].shape[-1])(packed)

    def run_packed_eager(self, packed: dict, debug: bool = False):
        """`run_packed` op by op; with `debug` a third intermediates
        dict."""
        return withdraw(self.n_levels, **packed, debug=debug)

    def run(self, inputs: list[dict]):
        """inputs: list of withdraw input dicts (rootExit, ethAddr,
        tokenID, balance, idx, sign, ay, siblingsState). Returns
        (hash list of host ints, ok numpy bool array)."""
        with spans.span("witness.run"):
            return self.unpack_outputs(*self.run_packed(self.pack(inputs)))

    @staticmethod
    def unpack_outputs(h, ok):
        """(hash (16, B), ok (B,)) tensors -> (hash list of host ints, ok
        numpy bool array)."""
        with spans.span("witness.unpack"):
            return [int(v) for v in fr.unpack_np(h)], fr.to_numpy(ok)

    def run_debug(self, inputs: list[dict]):
        """Like run() but also returns the intermediates dict (the
        witness-vector export path), through the compiled debug route of
        that width."""
        h, ok, dbg = self.debug_call_for(len(inputs))(self.pack(inputs))
        return (*self.unpack_outputs(h, ok), dbg)
