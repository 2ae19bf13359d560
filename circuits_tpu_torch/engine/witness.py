"""Input packing + witness evaluation for RollupMain.

Port of `circuits_tpu/engine/witness.py` (RollupMain part): builder input
dict (Python ints, camelCase keys of the circom input JSON) -> packed
int64 limb tensors with the tx lane as batch axis -> one evaluation that
returns the public outputs and a validity verdict. The entry points run on
the card ("cuda") unless the caller names another device, and raise where
there is no card; they never carry on on the CPU by themselves. A caller
who passes `device="cpu"` (the tests) gets the plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import fr
from ..models.rollup_main import rollup_main

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


def _flags(vals, device) -> torch.Tensor:
    return torch.tensor([int(v) for v in vals], dtype=torch.int64,
                        device=device)


def pack_rollup_inputs(inp: dict, n_tx: int, n_levels: int,
                       max_l1_tx: int, max_fee_tx: int,
                       device="cuda") -> dict:
    """Builder/JSON input dict -> the models' tensors on `device`."""
    device = resolve_device(device)
    out = {}
    for k in _SCALARS:
        out[_snake(k)] = fr.pack([inp[k]], device)
    for k in _PER_TX_FIELD + _PER_FEE_FIELD:
        out[_snake(k)] = fr.pack(inp[k], device)
    for k in _PER_TX_FLAG:
        out[_snake(k)] = _flags(inp[k], device)
    out["sign3"] = _flags(inp["sign3"], device)
    # bits: (T, 256) LSB-first lists -> (256, T)
    bjj = np.array(inp["fromBjjCompressed"], dtype=np.int64).reshape(-1, 256)
    out["from_bjj_compressed"] = torch.from_numpy(
        np.ascontiguousarray(bjj.T)).to(device)
    # siblings: (T, L+1) -> (L+1, 16, T)
    for k in ("siblings1", "siblings2", "siblings3"):
        out[k] = fr.pack(inp[k], device).permute(2, 0, 1).contiguous()
    out["im_on_chain"] = _flags(inp["imOnChain"], device)
    for k, name in _IM_FIELD.items():
        out[name] = fr.pack(inp[k], device)
    # (T-1, F) -> (F, 16, T-1)
    acc = fr.pack(inp["imAccFeeOut"], device)
    if acc.dim() == 2:  # T = 1: an empty chain
        acc = acc.reshape(16, 0, max_fee_tx)
    out["im_acc_fee_out"] = acc.permute(2, 0, 1).contiguous()
    return out


class RollupEngine:
    """RollupMain(nTx, nLevels, maxL1Tx, maxFeeTx) witness engine on one
    device."""

    def __init__(self, n_tx, n_levels, max_l1_tx, max_fee_tx,
                 device="cuda"):
        self.params = (n_tx, n_levels, max_l1_tx, max_fee_tx)
        self.device = resolve_device(device)

    def pack(self, inp: dict) -> dict:
        return pack_rollup_inputs(inp, *self.params, device=self.device)

    def run_packed(self, packed: dict):
        """Packed tensors -> (outputs dict of tensors, ok 0-d tensor)."""
        n_tx, n_levels, max_l1_tx, max_fee_tx = self.params
        return rollup_main(packed, n_tx=n_tx, n_levels=n_levels,
                           max_l1_tx=max_l1_tx, max_fee_tx=max_fee_tx)

    def run(self, inp: dict):
        """inp: builder input dict. Returns (outputs dict of host ints,
        ok bool)."""
        out, ok = self.run_packed(self.pack(inp))
        return self.unpack_outputs(out), bool(ok)

    @staticmethod
    def unpack_outputs(out: dict) -> dict:
        res = {k: fr.unpack_int(out[k]) for k in
               ("hash_global_inputs", "new_state_root", "new_exit_root",
                "new_last_idx")}
        res["acc_fee_out"] = [int(v) for v in fr.unpack_np(
            out["acc_fee_out"].movedim(1, 0))]
        return res
