"""The port's `check_batch` on the CPU against the JAX package's, at the
suite's config (3, 16, 2, 2): a valid batch, a tampered tx lane, a
tampered fee slot and the valid batch again give the same per-lane and
per-slot masks, and the masks name the lane and the slot that were
tampered. Then one case for each residual that the port writes in
another form than the JAX package (`r1cs/audit.py`: rollup-main.circom
:215, :263, :387, rollup-tx.circom:259 and the EdDSA identity), each a
batch tampered so that the residual refuses a lane, and the valid batch
with a transfer to a BabyJubJub address that :259 needs. Exact. The
cases go in that order through the `debug_call` of the one engine that
the checker keeps for the circuit and device (`checker.engine_for`): the
first runs op by op, the second is the capture (on the CPU a plain call),
the rest are replays."""

import copy

import numpy as np
import pytest
import torch

from circuits_tpu.engine.witness import pack_rollup_inputs as j_pack
from circuits_tpu.r1cs.checker import check_batch as j_check_batch
from circuits_tpu_torch.builder.account import HermezAccount
from circuits_tpu_torch.builder.babyjub import sign_poseidon
from circuits_tpu_torch.engine.aot import rollup_input_shapes
from circuits_tpu_torch.engine.witness import pack_rollup_inputs
from circuits_tpu_torch.ops.poseidon_constants import poseidon_py
from circuits_tpu_torch.r1cs import checker
from circuits_tpu_torch.r1cs.checker import check_batch

from torch_compare import (SUITE_CONFIG, one_thread,  # noqa: F401
                           suite_batches, to_bjj_batch)  # one_thread: autouse


def bump(key, index, delta):
    """A tamper: the input `key` at `index` (an int, or a tuple into a
    nested list) plus `delta`."""
    index = index if isinstance(index, tuple) else (index,)

    def tamper(inp):
        inp[key] = copy.deepcopy(inp[key])
        row = inp[key]
        for i in index[:-1]:
            row = row[i]
        row[index[-1]] += delta
    return tamper


def flip_to_bjj_sign(inp):
    """Lane 0's transfer to a BabyJubJub address with toBjjSign flipped in
    txCompressedData and txCompressedDataV2, and signed anew by its
    sender: the signature and the data hold, and only the receiver's sign
    (rollup-tx.circom:259) disagrees."""
    tcd = inp["txCompressedData"][0] ^ (1 << 224)
    inp["txCompressedData"] = [tcd] + list(inp["txCompressedData"][1:])
    inp["txCompressedDataV2"] = [inp["txCompressedDataV2"][0] ^ (1 << 216)] \
        + list(inp["txCompressedDataV2"][1:])
    element1 = (inp["toEthAddr"][0] | inp["amountF"][0] << 160
                | inp["maxNumBatch"][0] << 200)
    h = poseidon_py([tcd, element1, inp["toBjjAy"][0],
                     inp["rqTxCompressedDataV2"][0], inp["rqToEthAddr"][0],
                     inp["rqToBjjAy"][0]])
    sig = sign_poseidon(HermezAccount(1).private_key, h)
    for key, v in (("s", sig["S"]), ("r8x", sig["R8"][0]),
                   ("r8y", sig["R8"][1])):
        inp[key] = [v] + list(inp[key][1:])


# case -> (batch, tamper, lanes refused, fee slots refused); "l2" is the
# suite's L2 batch, "to_bjj" `torch_compare.to_bjj_batch`
CASES = {
    "valid": ("l2", None, [], []),
    # the sender's balance no longer matches its leaf
    "tampered lane": ("l2", bump("balance1", 1, 7), [1], []),
    # the fee recipient's leaf no longer matches the fee tree's root
    "tampered fee slot": ("l2", bump("balance3", 0, 1), [], [0]),
    # the first batch again, through the replay
    "valid again": ("l2", None, [], []),
    # rollup-main.circom:215: a fromBjjCompressed "bit" of 2
    "bjj bit of 2": ("l2", bump("fromBjjCompressed", (0, 0), 2), [0], []),
    # :263: the im chain says lane 0 is on chain, lane 0 says it is not
    "im onChain flipped": ("l2", bump("imOnChain", 0, 1), [0], []),
    # :387: lane 0's accumulated fee pin, which lane 1 also reads
    "im acc fee + 1": ("l2", bump("imAccFeeOut", (0, 0), 1), [0, 1], []),
    # the batch of the next case, untampered
    "to bjj valid": ("to_bjj", None, [], []),
    # rollup-tx.circom:259
    "to bjj sign flipped": ("to_bjj", flip_to_bjj_sign, [0], []),
    # the EdDSA identity: lane 0's signature scalar
    "signature corrupted": ("l2", bump("s", 0, 1), [0], []),
}


@pytest.fixture(scope="module")
def checked():
    """{case: (port's result, JAX's result)} and the checker's
    `debug_call`'s (warm, captured, replays) after each case; its engine is
    made fresh, since the checker keeps its engines as long as the
    process."""
    key = (SUITE_CONFIG, torch.device("cpu"))
    checker._ENGINES.pop(key, None)
    bases = {"l2": suite_batches()["l2"].get_input(),
             "to_bjj": to_bjj_batch().get_input()}
    res, states = {}, []
    for case, (batch, tamper, _, _) in CASES.items():
        inp = dict(bases[batch])
        if tamper is not None:
            tamper(inp)
        got = check_batch(pack_rollup_inputs(inp, *SUITE_CONFIG,
                                             device="cpu"), *SUITE_CONFIG)
        call = checker._ENGINES[key].debug_call
        states.append((call.warm, call.outputs is not None, call.replays))
        want = (res["valid"][1] if case == "valid again" else
                j_check_batch(j_pack(inp, *SUITE_CONFIG), *SUITE_CONFIG))
        res[case] = (got, want)
    return res, states


@pytest.mark.parametrize("mask", ["lane_ok", "fee_ok"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_check_batch_matches_jax(checked, case, mask):
    got, want = checked[0][case]
    assert isinstance(got[mask], np.ndarray) and got[mask].dtype == np.bool_
    assert got[mask].shape == want[mask].shape
    assert got[mask].tolist() == want[mask].tolist()
    assert got["ok"] is want["ok"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_batch_names_what_was_tampered(checked, case):
    got = checked[0][case][0]
    _, _, lanes, slots = CASES[case]
    assert np.flatnonzero(~got["lane_ok"]).tolist() == lanes
    assert np.flatnonzero(~got["fee_ok"]).tolist() == slots
    assert got["ok"] == (not lanes and not slots)
    assert sorted(got) == ["fee_ok", "lane_ok", "ok"]


def test_check_batch_runs_through_one_compiled_check(checked):
    """Op by op, the capture, then a replay a case; one engine a circuit
    and device, whose `debug_call` at the packed shapes is the check's only
    CapturedCall: the engine's main call never ran."""
    res, states = checked
    assert states == [(True, False, 0), (True, True, 0)] + [
        (True, True, i) for i in range(1, len(CASES) - 1)]
    engine = checker.engine_for(SUITE_CONFIG, "cpu")
    assert engine is checker._ENGINES[SUITE_CONFIG, torch.device("cpu")]
    call = engine.debug_call
    assert call.fn == engine.debug_eager
    assert call.shapes == rollup_input_shapes(*SUITE_CONFIG)
    assert call.pool is None and call.graph is None
    assert engine.call._inputs is None and engine.call.outputs is None
    assert checker.engine_for((4, 16, 2, 2), "cpu") is not engine
    first, again = res["valid"][0], res["valid again"][0]
    for mask in ("lane_ok", "fee_ok"):
        assert first[mask].tolist() == again[mask].tolist()
        assert first[mask] is not again[mask]
