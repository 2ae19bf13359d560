"""Drive the PyTorch/CUDA port's paths once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is then non-zero):
 1. print the card (nvidia-smi name, power limit) and the torch/CUDA
    versions; refuse to run without CUDA;
 2. build the kernels from circuits_tpu_torch/csrc with nvcc (sm_90a), one
    nvcc a source, all at once; print each kernel's registers and spills
    and the card's sustained rate of `fr_mont_mul` (csrc/mont_rate.cu),
    the unit of the Poseidon, SMT and EdDSA kernels' bounds;
 3. check each kernel against its plain PyTorch version on the card,
    exactly, at 1, 33 and 1000 lanes (no multiples of a thread group or a
    block): K1 Poseidon t = 3..7, K2 SMT chain on INSERT / UPDATE / DELETE
    / NOP lanes and on lanes that act at the root and at the bottom level,
    K3 EdDSA on valid, tampered and s >= 2^253 lanes and on edge lanes (A
    off the curve, A or R8 the identity, hm = 0, S = 0, every hm digit 15),
    K4 SHA-256 on both sides of its choice of route, on several narrow
    lanes, at 1 to 822 blocks and on a batch of 32768 withdrawals' 2 blocks
    (its wide route, timed; lanes also against hashlib); then
    again at the lane counts of the main path's calls at RollupMain(2048,
    32, 256, 64), where both versions are timed; K3 also with the card
    filled (32768 lanes, the kernel alone), and beside its throughput bound
    the time of one lane's own chain of dependent products; AySign2Ax
    (csrc/ay_sign.cu, no TPU original) on its edge lanes at 1, 33 and 1000
    lanes and timed at 2048;
 4. build a RollupMain(2048, 32, 256, 64) batch with the port's builder
    (2048 accounts by L1 deposits, 2048 signed L2 transfers, one fee
    token), run `RollupEngine.run` on the card (the engine's first batch,
    op by op; the engine that `check_batch` keeps for this circuit and
    card, `checker.engine_for`), hold the hash, roots and newLastIdx
    exactly against the builder, and require that every kernel of that path
    (kernels.MAIN_PATH) was launched during that run; then the second
    batch, which captures the engine as a CUDA graph (engine/aot.py: timed,
    its node count and memory kept for phase 13) and replays it: the
    graph's kernel nodes, read from the graph by the kernels' handles,
    must be the first run's launches, and a replay must call no wrapper;
    then record the arguments of that path's K1 and K2 calls in one more
    run on the eager route (`run_packed_eager`: a replay calls no Python
    wrapper), and check and time K2 on the batch's own 4096-lane call,
    whose masks give its bound;
 5. tamper one lane's signature scalar and require ok == False;
 6. time the host build, pack, first call and steady state;
 7. the full-round experiment (Poseidon t=3 full rounds, K5 with the MDS
    mix on the CUDA cores, K6 with it on the tensor cores): each kernel
    exactly against its plain version, both against the bigint mirror and
    each other, at 1, 33 and 257 lanes (K6's geometry: 32 lanes a warp,
    256 a block) x 0, 1 and 3 rounds, on the edge lanes of
    scripts/rounds_cases.py x 1 and 3 rounds, at 1000 x 3 and at 65536 x
    16 (timed; then both at 1, 4 and 16 rounds in turns);
    then its entry point `circuits_tpu_torch.scripts.exp_mxu_inkernel`
    at 65536 x 16, which must launch both kernels;
 8. Withdraw(32) on the card: `WithdrawEngine(32).run` on 32768 withdrawal
    lanes out of one exit tree of as many leaves, built on the host from
    the seed (scripts/withdraw_cases.py): every ok True and every hash
    exact against the builder's `hash_inputs_withdraw`; a second run with
    known lanes tampered (balance, sibling, idx, idx past 2^nLevels) refuses
    exactly those (the width's first batch runs op by op, the second
    captures the graph and replays it); K1 and K4 launched (K4 once, above
    its narrow route's lane limit, so on its wide route) and K2, K3 not,
    by the wrappers' counts and by the graph's kernel nodes alike; the
    same on one lane (K4's narrow route) over five batches, each width its
    own captured graph in the engine's one memory pool; the path's K1
    and K4 calls recorded on the eager route; `run_packed` timed (median of
    5, each ending in a host copy of the hashes), and its layers (state
    hash, verifier, hash) each on their own;
 9. the compiled debug route (engine/aot.py) on phase 4's engine and
    batch A and a second production batch B from the seed (phase 13's):
    `debug_call`, the one debug evaluation of RollupMain, run on A op by
    op (the warm-up, its wrapper launches counted), captured at B
    (recording, instantiation, node count, the kernel nodes read from the
    graph equal to those launches, the reserved memory before and after,
    the static outputs' and inputs' bytes) and replayed on A, B and A
    equal to the eager route limb for limb, then a replay median of 5
    beside the eager route's median of 3 with `max_memory_allocated` of
    each; then every entry point that reads it, each one replay:
    `_full_debug` gives `run`'s outputs and verdict and B's the builder's,
    `trace` agrees with the builder's input on lane_ok, decode.fromIdx and
    the chain of newStateRoot, `get_signal` one lane, `check_batch` on
    phase 5's tampered batch names lane 5 and no other; the main graph,
    `debug_call` and the main graph replayed in turns out of the engine's
    one pool, each exact;
    `export_witness` + `write_wtns` at RollupMain(2048, 32, 256, 64)
    through the replayed `debug_call`, its device part and the bytes' read
    as ints apart, and `handoff`'s file the same bytes; then the witness
    vector at a smaller depth with the widths kept: `export_witness` ->
    `write_wtns` -> `load_witness` ->
    `verify_witness` (pure Python) on a RollupMain(16, 32, 8, 4) batch and
    `export_witness_withdraw` -> `verify_withdraw_witness` on 8 lanes of
    phase 8, each of which must pass and must fail with one value changed;
    last, Withdraw's `run_debug` on phase 8's 32768 lanes: op by op, the
    capture at a batch with 64 lanes tampered (exactly those refused
    through the graph, every hash the builder's), hash, ok and state_hash
    replayed equal to the eager route, both routes timed; then the check
    at maxFeeTx = 1 (RollupMain(2, 16, 1, 1)), a fresh engine's
    `debug_call` under `check_batch` on a valid batch and on one with the
    fee recipient's balance3 + 7 (op by op, the capture, both replayed and
    timed), `fee_ok` [True] and [False] of shape (1,), and
    `check_batch_sharded` in a world of one over NCCL giving the same
    masks;
10. the modules with no kernel of their own, on the card: the BabyJubJub
    point operations (`scalar_mul_base8` and `scalar_mul_var` of BASE8 on
    1024 random scalars below the subgroup order, `points_equal` on every
    lane, 16 lanes' affine points against the host `mul_point`), and the
    8-bit-limb Poseidon `permute_mont_mxu` against `permute_mont` (K1) for
    t = 3..7 at 4096 lanes, exactly, both timed;
11. the CLI on the card, each verb its own `python -m
    circuits_tpu_torch.tools.cli` process in a temporary directory:
    `create`, `input` (32 accounts, 16 transfers, RollupMain(32, 16, 8,
    64)), `witness`, `check` on it and on a copy with one balance changed,
    `trace` of one signal and `witnessfull` (the five that read the input
    side by side), each exit code and the hash `input` printed held; then
    `compile 2048 32 256 64` alone, whose kernel library, capture and first
    replay give the time a fresh process takes to its first witness; the
    seconds of each verb (not `audit`: host text work, nothing on the
    card);
12. the tx-lane sharded path (`circuits_tpu_torch/parallel`) on phase 4's
    batch: a world of one over NCCL in this process, its outputs limb-equal
    to `run_packed`, the hash to the builder's, every kernel of the main
    path launched, timed (median of 3); then a world of two, two
    `circuits_tpu_torch.scripts.multihost_worker` processes on this one
    card over gloo, fed one batch file that each runs twice: every hash
    the builder's, each rank's launches of K1-K4 and seconds printed, and
    `check_batch_sharded` on a copy with lanes 5 and 1024 (rank 1's first)
    tampered names exactly those;
13. the captured engines (engine/aot.py) on phase 4's and phase 8's
    batches: the graph's outputs limb-equal to `run_packed_eager`'s and the
    builder's; phase 5's tampered batch refused through the graph; batches
    A, B, A (B phase 9's second production batch) replayed exactly;
    Withdraw's tampered lanes refused through its graph, exactly those;
    the capture's seconds, its node count (`cuGraphGetNodes`) and memory,
    `torch.cuda.max_memory_allocated` of each route, and both routes'
    `run_packed` medians of 5 for RollupMain and Withdraw, every run
    printed; what the one-lane Withdraw graph added to the engine's shared
    pool.

Each kernel's `bound_ms` is the larger of its bytes (every input read once,
every output written once) over 3.35 TB/s and its operations over the
card's rate for them: Montgomery products over the measured `fr_mont_mul`
rate, K6's mix over the published 1,979 TOP/s int8, K4's serial chain of
rounds (3 dependent operations a round) over the card's clock. No PyTorch call computes any of the seven
functions, so `library_ms` is null in every row.

The line before the last is {"kernels": [...]} (each row also with the
kernel nodes of phase 4's graph, of the 32768-lane Withdraw graph, its
launches in phase 12's world of one, and the kernel nodes of phase 9's
debug graphs: RollupMain's `debug_call` and Withdraw's `run_debug` at
32768 lanes);
the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import filecmp
import hashlib
import json
import os
import random
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from circuits_tpu_torch import kernels  # noqa: E402
from circuits_tpu_torch.engine import witness_vector  # noqa: E402
from circuits_tpu_torch.engine.witness import (  # noqa: E402
    RollupEngine, WithdrawEngine, pack_rollup_inputs)
from circuits_tpu_torch.builder import babyjub, float40  # noqa: E402
from circuits_tpu_torch.builder.account import HermezAccount  # noqa: E402
from circuits_tpu_torch.builder.rollup_db import RollupDB  # noqa: E402
from circuits_tpu_torch.builder.smt import SMT  # noqa: E402
from circuits_tpu_torch.builder.withdraw_utils import (  # noqa: E402
    hash_inputs_withdraw)
from circuits_tpu_torch.field import fr, scalar  # noqa: E402
from circuits_tpu_torch.models import hash_inputs  # noqa: E402
from circuits_tpu_torch.models.rollup_tx import hash_state  # noqa: E402
from circuits_tpu_torch.ops import (babyjubjub, poseidon,  # noqa: E402
                                    poseidon_constants, poseidon_mxu,
                                    poseidon_rounds, sha256, smt)
from circuits_tpu_torch.parallel import (  # noqa: E402
    make_sharded_rollup_main, make_tx_mesh)
from circuits_tpu_torch.r1cs import checker  # noqa: E402
from circuits_tpu_torch.r1cs.checker import (  # noqa: E402
    check_batch, check_batch_sharded)
from circuits_tpu_torch.r1cs.witness_check import (  # noqa: E402
    verify_withdraw_witness, verify_witness)
from circuits_tpu_torch.scripts import (eddsa_cases,  # noqa: E402
                                        exp_mxu_inkernel, multihost_worker,
                                        rounds_cases, withdraw_cases)

LANES = 1000
RAGGED = (1, 33)  # lane counts below a warp's and a block's lanes
N_LEVELS = 32
SEED = 20261016
SOURCES = {
    "poseidon_permute": ("circuits_tpu_torch/csrc/poseidon.cu",
                         "circuits_tpu/ops/pallas_poseidon.py:349"),
    "smt_chain": ("circuits_tpu_torch/csrc/smt.cu",
                  "circuits_tpu/ops/pallas_smt.py:140"),
    "eddsa_check": ("circuits_tpu_torch/csrc/eddsa.cu",
                    "circuits_tpu/ops/pallas_eddsa.py:268"),
    "sha256_chain": ("circuits_tpu_torch/csrc/sha256.cu",
                     "circuits_tpu/ops/pallas_sha256.py:92"),
    "poseidon_rounds_vpu": ("circuits_tpu_torch/csrc/poseidon_rounds.cu",
                            "scripts/exp_mxu_inkernel.py:230"),
    "poseidon_rounds_mxu": ("circuits_tpu_torch/csrc/poseidon_rounds.cu",
                            "scripts/exp_mxu_inkernel.py:220"),
    # the port's own kernel: the JAX package computes it in plain JAX
    "ay_sign_to_ax": ("circuits_tpu_torch/csrc/ay_sign.cu", None),
}
# the full-round experiment at the JAX script's defaults
EXP_LANES, EXP_ROUNDS = 65536, 16
# K6's geometry edges: one lane, a warp and one, a block (256 lanes) and one
FULL_ROUND_EDGES = [(lanes, rounds) for lanes in (1, 33, 257)
                    for rounds in (0, 1, 3)]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
INT8_OPS_PER_S = 1.979e15  # dense int8 tensor-core peak, the same sheet
# 32-bit multiply-add instruction slots of one fr_mont_mul
# (csrc/field.cuh): 8 x (8 + 8) wide products and 8 low ones, with their
# carry adds about 270
MONT_MUL_SLOTS = 270
INT32_LANES_PER_SM = 64
# K3 (csrc/eddsa.cu), on the curve's a = 1 form: products a group of four
# threads forms at each step of a doubling and of a unified add, and the
# products of a mixed add (Z2 = 1, and the comb's third column), which ride
# in the free slots (tests/test_torch_eddsa.py holds the same tables against
# the host curve code)
EDDSA_DBL_STEPS, EDDSA_ADD_STEPS = (4, 3), (4, 2, 1, 3, 2)
EDDSA_MIXED_ADD = 11
# Montgomery products a lane: Ax and R8x mapped, a 14-add table (mixed adds),
# 64 windows of 4 doublings, a unified add and a mixed add, the mixed add of
# R8 and the 4 products of the projective comparison
EDDSA_PRODUCTS = (2 + 14 * EDDSA_MIXED_ADD
                  + 64 * (4 * sum(EDDSA_DBL_STEPS) + sum(EDDSA_ADD_STEPS)
                          + EDDSA_MIXED_ADD) + EDDSA_MIXED_ADD + 4)
# steps of one lane's chain, one dependent product each
EDDSA_STEPS = (2 + 14 * len(EDDSA_ADD_STEPS)
               + 64 * (4 * len(EDDSA_DBL_STEPS) + len(EDDSA_ADD_STEPS))
               + len(EDDSA_ADD_STEPS) + 1)
EDDSA_MAIN_PATH_LANES, EDDSA_FILLED_LANES = 2048, 32768
# AySign2Ax (csrc/ay_sign.cu), a lane: the Montgomery products it forms (y to
# Montgomery form, y^2, D y^2; the inverse's 254 steps and the sqrt power's
# 225, two products each; num / den; r and t; Tonelli-Shanks' 27 steps of
# three products and their 351 squarings; r^2 and r canonical), and the steps
# of its chain of dependent ones (a power's multiply hides behind its
# squaring, a Tonelli-Shanks step's r c behind c^2)
AY_SIGN_PRODUCTS = 3 + 2 * 254 + 1 + 2 * 225 + 2 + 27 * 3 + 351 + 2
AY_SIGN_STEPS = 3 + 254 + 1 + 225 + 2 + 27 * 2 + 351 + 2
AY_SIGN_MAIN_PATH_LANES = 2048  # one signature's key a tx lane
SHA_BLOCKS = 822  # the HashInputs preimage at RollupMain(2048, 32, 256, 64)
# a SHA-256 round's chain from e to the next e, once h + K + W + d is formed
# ahead: a funnel shift of Sigma1, the three-input xor, the three-input add
# (SHF, LOP3, IADD3), each with the ALU's latency
SHA_DEPENDENT_OPS, ALU_LATENCY_CLOCKS = 3, 4
# 32-bit integer operations of one message block at their least: a round is
# 6 shifts, 4 three-input logic operations (Sigma0, Sigma1, Ch, Maj) and 4
# three-input adds; a schedule word (48 a block) 6 shifts, 2 xors and 2
# adds; K + W one add
SHA_BLOCK_OPS = 64 * 14 + 48 * 10 + 64
# HashInputs of Withdraw: 688 bits, 2 blocks a lane, one lane a withdrawal
# (`hash_inputs_withdrawal` of the JAX package); the lane count is the one K3
# is filled at. This is the shape that K4's wide route is for.
SHA_WITHDRAW = (32768, 2)
WITHDRAW_LANES = SHA_WITHDRAW[0]
# the witness vector's depth: the widths of the production batch (nLevels
# 32, 736-bit L1 data), 16 tx lanes, since its checker re-derives every
# Poseidon, SMT proof and EdDSA check in Python integers
EXPORT_CONFIG = (16, N_LEVELS, 8, 4)
EXPORT_WITHDRAW_LANES = 8


def poseidon_products(t: int) -> int:
    """Montgomery products of one permutation in the sparse schedule."""
    rp = poseidon_constants.N_ROUNDS_P[t - 2]
    return 8 * (t * t + 3 * t) + rp * (2 * t + 2)


# Poseidon(2) of canonical inputs: to Montgomery form (2), permute, back (1)
HASH2_PRODUCTS = poseidon_products(3) + 3


def sync():
    torch.cuda.synchronize()


def kernel_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls (CUDA events); the
    caller has made a warm-up call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def plain_ms(fn) -> float:
    """Host milliseconds of one synchronised call of `fn`; the caller has
    made a warm-up call."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def max_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    return int((a.long() - b.long()).abs().max().item())


results = {}
# "mont_mul": products/s measured; "chain_ns": one product of a dependent
# chain, a warp alone on its scheduler; "clock_hz": max SM clock
rates = {}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops_s: float, moved_bytes: int):
    """(bound_ms, bound_by): the larger of the operations' time `ops_s` and
    the bytes' time at the card's memory rate."""
    bytes_s = moved_bytes / HBM_BYTES_PER_S
    if bytes_s > ops_s:
        return bytes_s * 1e3, "bytes"
    return ops_s * 1e3, "operations"


def compare(name, note, kernel_fn, plain_fn, reps, timed=True, bound_of=None):
    """Hold the kernel's result against its plain version's, exactly, and
    time both when `timed`; the last timed shape of a kernel is the one
    reported in the kernels line, with `bound_of` = (seconds of its
    operations at the card's rate, bytes it must move). Returns the
    kernel's result."""
    got = kernel_fn()  # also the warm-up calls of both
    err = max_err(got, plain_fn())
    r = results.setdefault(name, dict(err=0, ms=None, plain_ms=None))
    r["err"] = max(r["err"], err)
    line = f"  {name:17s} {note:36s} max_abs_err={err}"
    if timed:
        r["ms"], r["plain_ms"] = kernel_ms(kernel_fn, reps), plain_ms(plain_fn)
        r["bound_ms"], r["bound_by"] = bound(*bound_of)
        line += (f" kernel={r['ms']:.4f} ms plain={r['plain_ms']:.1f} ms "
                 f"bound={r['bound_ms']:.4f} ms ({r['bound_by']}; kernel "
                 f"reaches {100 * r['bound_ms'] / r['ms']:.1f} % of it)")
    print(line, flush=True)
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({note}): max_abs_err={err}")
    return got


def tile(x, lanes):
    """Repeat a tensor's lanes (last axis) up to `lanes`."""
    reps = -(-lanes // x.shape[-1])
    return x.repeat((1,) * (x.dim() - 1) + (reps,))[..., :lanes].contiguous()


# (t, lanes) of the main path's Poseidon calls at RollupMain(2048, ...):
# t=3 new1h and t=5 HashState pairs over 4096 lanes, t=4 SMT leaves over
# 8192, t=6 EdDSA challenge and t=7 sigL2Hash over 2048
POSEIDON_MAIN_PATH = [(3, 4096), (4, 8192), (5, 4096), (6, 2048), (7, 2048)]
# lane counts that fill the card (more warps than a scheduler can hide
# behind), to tell what the main path's small calls cost K1
POSEIDON_FILLED = [(3, 65536), (7, 32768)]
# (t, lanes) of a Withdraw(32) batch's Poseidon calls at 32768 lanes: t=3 a
# level of the verifier (33 calls), t=4 the two leaf hashes, t=5 HashState
POSEIDON_WITHDRAW = [(3, WITHDRAW_LANES), (4, WITHDRAW_LANES),
                     (5, WITHDRAW_LANES)]


def check_poseidon(dev, rng):
    shapes = [(t, lanes) for t in range(3, 8) for lanes in RAGGED + (LANES,)]
    # the last one is reported
    timed = POSEIDON_FILLED + POSEIDON_WITHDRAW + POSEIDON_MAIN_PATH
    for t, lanes in shapes + timed:
        vals = [[rng.randrange(scalar.P) for _ in range(lanes)]
                for _ in range(t)]
        state = fr.pack(vals, dev).contiguous()  # (16, t, lanes), Mont.
        products = poseidon_products(t) * lanes
        compare("poseidon_permute", f"t={t} B={lanes}",
                lambda: poseidon.permute_mont(state),
                lambda: poseidon.permute_mont_plain(state), 10,
                timed=(t, lanes) in timed,
                bound_of=(products / rates["mont_mul"], 2 * nbytes(state)))
    # and one hash against the host bigint Poseidon
    x = [rng.randrange(scalar.P) for _ in range(4)]
    h = poseidon.poseidon([fr.pack([v], dev) for v in x])
    assert fr.unpack_int(h) == poseidon_constants.poseidon_py_pure(x)


def _smt_lanes(rng, n_levels):
    """1000 SMTProcessor proofs from the host tree: INSERT (with push-down
    and into empty slots), UPDATE, DELETE and NOP lanes."""
    tree = SMT()
    keys = rng.sample(range(1, 1 << 20), 400)
    for k in keys[:200]:
        tree.insert(k, k * 7 + 1)
    ops = []
    for k in keys[200:450]:
        pr = tree.insert(k, k * 11 + 3)
        pr["fnc"] = (1, 0)
        ops.append(pr)
    for k in rng.sample(keys[:200], 150) + rng.sample(keys[200:400], 100):
        pr = tree.update(k, rng.randrange(scalar.P))
        pr["fnc"] = (0, 1)
        ops.append(pr)
    for k in rng.sample(keys, 250):
        pr = tree.delete(k)
        pr["fnc"] = (1, 1)
        pr["new_key"] = pr.pop("del_key")
        pr["new_value"] = pr.pop("del_value")
        ops.append(pr)
    while len(ops) < LANES:
        ops.append(dict(old_root=tree.root,
                        siblings=[rng.randrange(scalar.P)] * 2,
                        old_key=rng.randrange(1 << 20),
                        old_value=rng.randrange(scalar.P), is_old0=False,
                        new_key=rng.randrange(1 << 20),
                        new_value=rng.randrange(scalar.P), fnc=(0, 0),
                        new_root=tree.root))
    n = n_levels + 1
    return ops, n


def _smt_edge_lanes(rng, n_levels):
    """33 proofs on a shallow tree: lane 0 inserts into the empty tree (it
    acts at the root), lane 1 inserts a key that shares all but its last
    path bit with lane 0's, so the old leaf is pushed down to the bottom
    level; then inserts, updates and deletes."""
    tree = SMT()
    deep = 1 + (1 << (n_levels - 1))
    keys = [1, deep] + rng.sample(
        [k for k in range(2, 1 << n_levels) if k != deep], 14)
    ops = []
    for k in keys:
        pr = tree.insert(k, rng.randrange(scalar.P))
        pr["fnc"] = (1, 0)
        ops.append(pr)
    for k in rng.sample(keys, 9):
        pr = tree.update(k, rng.randrange(scalar.P))
        pr["fnc"] = (0, 1)
        ops.append(pr)
    for k in rng.sample(keys, 8):
        pr = tree.delete(k)
        pr["fnc"] = (1, 1)
        pr["new_key"] = pr.pop("del_key")
        pr["new_value"] = pr.pop("del_value")
        ops.append(pr)
    return ops, n_levels + 1


def _smt_args(ops, n, dev):
    """`smt.processor`'s arguments (without old_root) for host proofs."""
    sib = fr.pack([o["siblings"] + [0] * (n - len(o["siblings"]))
                   for o in ops], dev).permute(2, 0, 1).contiguous()

    def col(key):
        return fr.pack([o[key] for o in ops], dev)

    def flag(fn):
        return torch.tensor([fn(o) for o in ops], device=dev)

    return dict(siblings=sib, old_key=col("old_key"),
                old_value=col("old_value"),
                is_old0=flag(lambda o: int(o["is_old0"])),
                new_key=col("new_key"), new_value=col("new_value"),
                fnc0=flag(lambda o: o["fnc"][0]),
                fnc1=flag(lambda o: o["fnc"][1]))


def smt_bound_of(cargs):
    """K2's operations and bytes for these chain arguments: the hashes the
    masks select (old and new chain under `top`, the bottom pair under
    `bot`), and every argument read once, both outputs written once."""
    masks = cargs[2]
    hashes = int(2 * masks[:, 0].sum() + masks[:, 2].sum())
    moved = nbytes(cargs[0], *cargs[3:]) + 2 * nbytes(cargs[3])
    moved += cargs[1].numel() + masks.numel()  # one byte a bit and a mask
    return hashes, (hashes * HASH2_PRODUCTS / rates["mont_mul"], moved)


def check_smt(dev, rng):
    ops, n = _smt_lanes(rng, N_LEVELS)
    args = _smt_args(ops, n, dev)
    cargs = smt.chain_args(**args)
    compare("smt_chain", f"n={n} B={LANES} ins/upd/del/nop",
            lambda: smt.processor_chain(*cargs),
            lambda: smt.processor_chain_plain(*cargs), 5, timed=False)
    new_root, ok = smt.processor(
        fr.pack([o["old_root"] for o in ops], dev), **args)
    assert bool(ok.all()), "SMT processor rejected a valid host proof"
    want_roots = [o["new_root"] for o in ops]
    assert [int(v) for v in fr.unpack_np(new_root)] == want_roots
    # 1 and 33 lanes, with actions at the root and at the bottom level
    edge, n = _smt_edge_lanes(rng, 8)
    for lanes in RAGGED:
        sub = edge[:lanes]
        args = _smt_args(sub, n, dev)
        cargs = smt.chain_args(**args)
        masks = cargs[2]  # (n, 5, lanes), bottom-up: old0 is row 1, new1 3
        assert bool(masks[n - 1, 1, 0]), "lane 0 does not act at the root"
        assert lanes == 1 or bool(masks[1, 3, 1]), \
            "lane 1 does not act at the bottom level"
        compare("smt_chain", f"n={n} B={lanes} root/bottom actions",
                lambda: smt.processor_chain(*cargs),
                lambda: smt.processor_chain_plain(*cargs), 5, timed=False)
        new_root, ok = smt.processor(
            fr.pack([o["old_root"] for o in sub], dev), **args)
        assert bool(ok.all()), "SMT processor rejected a valid host proof"
        assert [int(v) for v in fr.unpack_np(new_root)] == \
            [o["new_root"] for o in sub]


def record_calls(run):
    """`run()` with the K1, K2 and K4 wrappers recorded: a count of K1's
    calls by (t, lanes), the arguments of K2's calls, a count of K4's calls
    by (blocks, lanes)."""
    k1, k4 = collections.Counter(), collections.Counter()
    chain_calls = []
    real = poseidon.permute_mont, smt.processor_chain, sha256.sha256_chain

    def permute(state):
        k1[tuple(state.shape[1:])] += 1
        return real[0](state)

    def chain(*cargs):
        chain_calls.append(cargs)
        return real[1](*cargs)

    def sha(words, nblocks):
        k4[(nblocks, words.shape[1])] += 1
        return real[2](words, nblocks)

    poseidon.permute_mont, smt.processor_chain = permute, chain
    sha256.sha256_chain = sha
    try:
        run()
        sync()
    finally:
        poseidon.permute_mont, smt.processor_chain = real[:2]
        sha256.sha256_chain = real[2]
    return k1, chain_calls, k4


def check_main_path_calls(dev, engine, packed):
    """One more run of the batch with the K1 and K2 wrappers recorded: the
    shapes and counts of the main path's Poseidon calls, and K2 checked
    and timed on the batch's own widest call, whose masks give its bound."""
    shapes, chain_calls, _ = record_calls(
        lambda: engine.run_packed_eager(packed))
    print("main path's Poseidon calls (t, lanes) x count: "
          + ", ".join(f"{k} x {v}" for k, v in sorted(shapes.items())),
          flush=True)
    print("main path's SMT chain calls (n, lanes): "
          + ", ".join(str((c[0].shape[0], c[0].shape[2]))
                      for c in chain_calls), flush=True)
    missing = set(POSEIDON_MAIN_PATH) - set(shapes)
    assert not missing, f"Poseidon shapes not on the main path: {missing}"
    cargs = max(chain_calls, key=lambda c: c[0].shape[2])
    n, lanes = cargs[0].shape[0], cargs[0].shape[2]
    hashes, bound_of = smt_bound_of(cargs)
    worst = 3 * n * lanes * HASH2_PRODUCTS / rates["mont_mul"] * 1e3
    print(f"  smt_chain: the batch's masks select {hashes} hashes "
          f"({hashes / lanes:.2f} a lane); all 3 x {n} levels would bound it "
          f"at {worst:.4f} ms", flush=True)
    compare("smt_chain", f"n={n} B={lanes} (the batch's call)",
            lambda: smt.processor_chain(*cargs),
            lambda: smt.processor_chain_plain(*cargs), 5, bound_of=bound_of)


def check_eddsa(dev, rng):
    sigs = []
    for i in range(40):
        prv = rng.randbytes(32)
        pub = babyjub.prv2pub(prv)
        msg = rng.randrange(scalar.P)
        sig = babyjub.sign_poseidon(prv, msg)
        sigs.append((pub, msg, sig["R8"], sig["S"]))
    lanes, expect = [], []
    for i in range(LANES):
        pub, msg, r8, s = sigs[i % len(sigs)]
        kind = i % 4
        if kind == 1:
            msg = (msg + 1) % scalar.P  # tampered message
        elif kind == 2:
            s = s + (1 << 253)  # read as 253 bits: still valid
        elif kind == 3:
            s = s + (1 << 252)  # bit 252 is read: invalid
        lanes.append((pub, msg, r8, s))
        expect.append(kind in (0, 2))
    ax = fr.pack([p[0][0] for p in lanes], dev)
    ay = fr.pack([p[0][1] for p in lanes], dev)
    msg = fr.pack([p[1] for p in lanes], dev)
    r8x = fr.pack([p[2][0] for p in lanes], dev)
    r8y = fr.pack([p[2][1] for p in lanes], dev)
    s = fr.pack([p[3] for p in lanes], dev)
    hm = poseidon.poseidon([r8x, r8y, ax, ay, msg]).contiguous()
    coords = [fr.to_mont(c).contiguous() for c in (ax, ay, r8x, r8y)]
    cargs = (coords[0], coords[1], s, coords[2], coords[3], hm)
    got = compare("eddsa_check", f"B={LANES} valid/tampered/s>=2^253",
                  lambda: babyjubjub.eddsa_ok_mont(*cargs),
                  lambda: babyjubjub.eddsa_ok_mont_plain(*cargs), 5,
                  timed=False)
    assert got.cpu().tolist() == expect, "EdDSA verdicts differ from host"
    # 1 and 33 lanes: less than a warp's 8 lanes, and a ragged last warp
    for n in RAGGED:
        sub = [x[:, :n].contiguous() for x in cargs]
        got = compare("eddsa_check", f"B={n}",
                      lambda: babyjubjub.eddsa_ok_mont(*sub),
                      lambda: babyjubjub.eddsa_ok_mont_plain(*sub), 5,
                      timed=False)
        assert got.cpu().tolist() == expect[:n]
    # edge lanes: the verdict is the host curve code's
    edge = eddsa_cases.edge_lanes(rng)
    eargs = eddsa_cases.kernel_args([row for _, row, _ in edge], dev)
    got = compare("eddsa_check", f"B={len(edge)} edge lanes",
                  lambda: babyjubjub.eddsa_ok_mont(*eargs),
                  lambda: babyjubjub.eddsa_ok_mont_plain(*eargs), 5,
                  timed=False)
    for (name, _, want), ok in zip(edge, got.cpu().tolist()):
        assert want is None or ok == want, f"EdDSA edge lane {name}: {ok}"
    # the card filled: the kernel alone, its verdicts those of the tiled lanes
    ops_s = EDDSA_PRODUCTS / rates["mont_mul"]
    full = [tile(x, EDDSA_FILLED_LANES) for x in cargs]
    got = babyjubjub.eddsa_ok_mont(*full)
    assert got.cpu().tolist() == [expect[i % LANES] for i in
                                  range(EDDSA_FILLED_LANES)]
    ms = kernel_ms(lambda: babyjubjub.eddsa_ok_mont(*full), 5)
    bound_ms, by = bound(ops_s * EDDSA_FILLED_LANES,
                         nbytes(*full) + EDDSA_FILLED_LANES)
    print(f"  eddsa_check       B={EDDSA_FILLED_LANES} (the card filled, "
          f"lanes tiled) verdicts as the {LANES} lanes' kernel={ms:.4f} ms "
          f"bound={bound_ms:.4f} ms ({by}; kernel reaches "
          f"{100 * bound_ms / ms:.1f} % of it)", flush=True)
    # the main path's call: one signature check per tx lane
    n = EDDSA_MAIN_PATH_LANES
    big = [tile(x, n) for x in cargs]
    compare("eddsa_check", f"B={n} (lanes tiled)",
            lambda: babyjubjub.eddsa_ok_mont(*big),
            lambda: babyjubjub.eddsa_ok_mont_plain(*big), 5,
            bound_of=(ops_s * n, nbytes(*big) + n))
    r = results["eddsa_check"]
    chain_ms = EDDSA_STEPS * rates["chain_ns"] * 1e-6
    binds = "the chain" if chain_ms > r["bound_ms"] else "the throughput"
    print(f"  eddsa_check       B={n}: a lane's chain is {EDDSA_STEPS} steps "
          f"x {rates['chain_ns']:.1f} ns = {chain_ms:.4f} ms, the throughput "
          f"bound {r['bound_ms']:.4f} ms: {binds} binds; the kernel reaches "
          f"{100 * chain_ms / r['ms']:.1f} % of the chain's time",
          flush=True)


def check_ay_sign(dev, rng):
    """AySign2Ax's kernel against its plain version on the edge lanes
    (`eddsa_cases.ay_sign_lanes`) and random ones at 1, 33 and 1000 lanes,
    its ax and ok also against the host's scalar version; then timed at the
    main path's 2,048 lanes beside its bound and its chain's time."""
    from circuits_tpu_torch.r1cs import witness_check as wc

    ays, signs = eddsa_cases.ay_sign_lanes(rng, LANES)
    ay = fr.pack(ays, dev)
    sign = torch.tensor(signs, dtype=torch.bool, device=dev)
    for n in RAGGED + (LANES,):
        a, sg = ay[:, :n].contiguous(), sign[:n].contiguous()
        got = compare("ay_sign_to_ax", f"B={n} edge and random lanes",
                      lambda: babyjubjub.ay_sign_to_ax(a, sg),
                      lambda: babyjubjub.ay_sign_to_ax_plain(a, sg), 5,
                      timed=False)
    host = [wc._ay_sign_to_ax(y, g) for y, g in zip(ays[:64], signs)]
    assert [(int(x), bool(k)) for x, k in zip(
        fr.unpack_np(got[0].cpu())[:64], got[1].tolist())] == host, \
        "AySign2Ax differs from the host"
    n = AY_SIGN_MAIN_PATH_LANES
    a, sg = tile(ay, n), tile(sign, n)
    compare("ay_sign_to_ax", f"B={n} (lanes tiled)",
            lambda: babyjubjub.ay_sign_to_ax(a, sg),
            lambda: babyjubjub.ay_sign_to_ax_plain(a, sg), 20,
            bound_of=(AY_SIGN_PRODUCTS * n / rates["mont_mul"],
                      nbytes(a, sg) + n * (16 * 8 + 1)))
    r = results["ay_sign_to_ax"]
    chain_ms = AY_SIGN_STEPS * rates["chain_ns"] * 1e-6
    print(f"  ay_sign_to_ax     B={n}: a lane's chain is {AY_SIGN_STEPS} "
          f"steps x {rates['chain_ns']:.1f} ns = {chain_ms:.4f} ms, the "
          f"kernel reaches {100 * chain_ms / r['ms']:.1f} % of it", flush=True)


def _sha_words(msgs, dev):
    """Messages of one length, hashlib-style padding -> (nblocks * 16, B)
    int64 words."""
    n = len(msgs[0])
    tail = b"\x80" + b"\x00" * ((55 - n) % 64) + (8 * n).to_bytes(8, "big")
    words = np.frombuffer(b"".join(m + tail for m in msgs), dtype=">u4")
    words = words.reshape(len(msgs), -1).T.astype(np.int64)
    return torch.from_numpy(words).to(dev).contiguous()


def sha_cases(dev):
    """(lanes, blocks) of K4's checks. The kernel serves a batch up to some
    lane count by its narrow route (a block a lane, stages of 32 message
    blocks) and more by its wide one; the library says where that is. Both
    sides of it, several narrow lanes at once, and chains that end at a
    stage's edge (32, 64), one past it (33) and inside one (97). The last two
    are timed: a batch of withdrawals (the wide route) and the main path's
    HashInputs preimage (the narrow one), which is the row reported."""
    edge = sha256.narrow_route_lanes(dev)
    return [(LANES, 1), (4, 5), (edge, 2), (edge + 1, 2), (1, 1), (1, 3),
            (1, 32), (1, 33), (1, 64), (1, 97), SHA_WITHDRAW, (1, SHA_BLOCKS)]


def check_sha(dev, rng):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_rate = INT32_LANES_PER_SM * sms * rates["clock_hz"]
    for lanes, nblocks in sha_cases(dev):
        msgs = [rng.randbytes(64 * nblocks - 9) for _ in range(lanes)]
        words = _sha_words(msgs, dev)
        # a lane is one serial chain of rounds, whose latency binds a narrow
        # batch; a wide one is bound by its count of integer operations
        chain_s = (nblocks * 64 * SHA_DEPENDENT_OPS * ALU_LATENCY_CLOCKS
                   / rates["clock_hz"])
        ops_s = lanes * nblocks * SHA_BLOCK_OPS / int32_rate
        got = compare("sha256_chain", f"nblocks={nblocks} B={lanes}",
                      lambda: sha256.sha256_chain(words, nblocks),
                      lambda: sha256.sha256_chain_plain(words, nblocks),
                      50 if (lanes, nblocks) == SHA_WITHDRAW else 5,
                      timed=(lanes, nblocks) in (SHA_WITHDRAW,
                                                 (1, SHA_BLOCKS)),
                      bound_of=(max(chain_s, ops_s),
                                nbytes(words) + 8 * 8 * lanes))
        state = got.cpu().tolist()
        for lane in range(0, lanes, max(1, lanes // 32)):
            digest = b"".join(row[lane].to_bytes(4, "big") for row in state)
            assert digest == hashlib.sha256(msgs[lane]).digest(), \
                f"SHA-256 != hashlib (lane {lane}/{lanes}, {nblocks} blocks)"


def _rounds_case(dev, state, vals, rounds, sample, note="", timed=False):
    """K5 and K6 on one state: each exactly against its plain version, the
    two against each other and against the bigint mirror on the lanes of
    `sample`; both timed (and their bounds reckoned) when `timed`."""
    x = state.to(dev)
    lanes = x.shape[-1]
    # a t=3 full round: 9 products of x^5 and 9 of the mix; K6's mix is
    # reckoned as 216 u8 mma.m16n8k32 (2 * 16 * 8 * 32 operations each)
    # for every 32 lanes
    work = rounds * lanes
    pow5_s = 9 * work / rates["mont_mul"]
    mix_mma_s = 216 * 2 * 16 * 8 * 32 * work / 32 / INT8_OPS_PER_S
    outs = [compare(name, f"R={rounds} B={lanes}{note}",
                    lambda fn=fn: fn(x, rounds),
                    lambda plain=plain: plain(x, rounds), 10, timed,
                    bound_of=(ops_s, 2 * nbytes(x)))
            for name, fn, plain, ops_s in (
                ("poseidon_rounds_vpu", poseidon_rounds.full_rounds_vpu,
                 poseidon_rounds.full_rounds_vpu_plain, 2 * pow5_s),
                ("poseidon_rounds_mxu", poseidon_rounds.full_rounds_mxu,
                 poseidon_rounds.full_rounds_mxu_plain,
                 pow5_s + mix_mma_s))]
    assert torch.equal(outs[0], outs[1]), f"K5 and K6 differ ({note})"
    got = fr.unpack_np(outs[0])
    for lane in sorted(sample):
        want = poseidon_rounds.full_rounds_py(
            [vals[e][lane] for e in range(3)], rounds)
        assert [int(got[e, lane]) for e in range(3)] == want, \
            f"lane {lane} differs from the bigint mirror ({note})"
    print(f"  K5 == K6 == bigint mirror on {len(sample)} lanes "
          f"(R={rounds} B={lanes}{note})", flush=True)


def check_full_rounds(dev, rng):
    """K5 and K6 against their plain versions, the bigint mirror and each
    other: at the edges of K6's geometry (1, 33 and 257 lanes, below a
    warp's, a block's and a block's plus one, at 0, 1 and 3 rounds; the
    edge lanes of scripts/rounds_cases.py), then at 1000 x 3 and, timed,
    at 65536 x 16; then the experiment's entry point with the counts from
    0. Returns the launches of that run."""
    t0 = time.perf_counter()
    for lanes, rounds in FULL_ROUND_EDGES:
        state, vals = exp_mxu_inkernel.random_state(lanes)
        _rounds_case(dev, state, vals, rounds, range(lanes))
    state, vals = rounds_cases.edge_lanes()
    for rounds in (1, 3):
        _rounds_case(dev, state, vals, rounds, range(len(vals[0])),
                     note=" edge lanes")
    print(f"  the geometry edges took {time.perf_counter() - t0:.1f} s",
          flush=True)
    for lanes, rounds in ((LANES, 3), (EXP_LANES, EXP_ROUNDS)):
        state, vals = exp_mxu_inkernel.random_state(lanes)
        sample = {0, 777, lanes - 1} | set(rng.sample(range(lanes), 29))
        _rounds_case(dev, state, vals, rounds, sample,
                     timed=lanes == EXP_LANES)
    # a round's cost apart from the state's load and store: both kernels
    # at 1, 4 and 16 rounds, timed in turns (K5, K6, K6, K5)
    x = state.to(dev)
    fns = (("K5", poseidon_rounds.full_rounds_vpu),
           ("K6", poseidon_rounds.full_rounds_mxu))
    for rounds in (1, 4, EXP_ROUNDS):
        ms = collections.defaultdict(list)
        for name, fn in fns + fns[::-1]:
            ms[name].append(kernel_ms(lambda fn=fn: fn(x, rounds), 10))
        print(f"  {EXP_LANES} lanes x {rounds} rounds: "
              + ", ".join(f"{n} {statistics.mean(v):.4f} ms"
                          for n, v in ms.items()), flush=True)
    kernels.reset_launches()
    exp_mxu_inkernel.run(EXP_LANES, EXP_ROUNDS, dev)
    launches = {k: kernels.launches[k]
                for k in ("poseidon_rounds_vpu", "poseidon_rounds_mxu")}
    print(f"exp_mxu_inkernel({EXP_LANES}, {EXP_ROUNDS}): launches={launches}",
          flush=True)
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched by its path"
    return launches


def median_s(fn, reps: int = 5) -> float:
    """Median host seconds of `fn()` over `reps` synchronised calls; the
    caller has made a warm-up call."""
    return statistics.median(plain_ms(fn) for _ in range(reps)) * 1e-3


def kept_memory() -> int:
    """Bytes the caching allocator keeps reserved once its free blocks are
    returned: live tensors and the captured graphs' pools."""
    sync()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def check_withdraw(rng, card):
    """Phase 8: Withdraw(nLevels = 32) through `WithdrawEngine` on the card
    at 32768 lanes and at one. Returns (the engine, the valid lanes, the
    kernels' launches of one 32768-lane `run`)."""
    t0 = time.perf_counter()
    lanes = withdraw_cases.exit_tree_batch(rng, WITHDRAW_LANES, N_LEVELS)
    want = [hash_inputs_withdraw(d) for d in lanes]
    depths = [len(d["siblingsState"]) for d in lanes]
    print(f"exit tree: {WITHDRAW_LANES} distinct leaves, one withdrawal a "
          f"leaf (none repeated), proofs of {min(depths)}-{max(depths)} "
          f"siblings, built on the host in {time.perf_counter() - t0:.1f} s",
          flush=True)
    engine = WithdrawEngine(N_LEVELS)  # no device named: the card
    dev = engine.device
    edge = sha256.narrow_route_lanes(dev)
    assert 1 <= edge < WITHDRAW_LANES, edge

    def run_counted(batch):
        """`engine.run(batch)` and the kernels it ran: the wrappers' own
        launches (a width's first batch runs op by op) and, for each replay
        of the width's graph, the graph's kernel nodes."""
        call = engine.call_for(len(batch))
        replays = call.replays
        kernels.reset_launches()
        hashes, ok = engine.run(batch)
        sync()
        assert isinstance(ok, np.ndarray) and ok.dtype == np.bool_
        assert ok.shape == (len(batch),) and len(hashes) == len(batch)
        counts = {k: n + (call.replays - replays) * call.counts[k]
                  for k, n in kernels.launches.items()}
        assert counts["poseidon_permute"] > 0, counts
        assert counts["sha256_chain"] == 1, counts
        assert counts["smt_chain"] == 0 and counts["eddsa_check"] == 0 \
            and counts["ay_sign_to_ax"] == 0, counts
        return hashes, ok, counts

    # every lane valid; then known lanes tampered, each kind in turn
    t0 = time.perf_counter()
    hashes, ok, launches = run_counted(lanes)
    t_first = time.perf_counter() - t0
    assert ok.all(), f"{int((~ok).sum())} valid withdrawals were refused"
    assert hashes == want, "hash != hash_inputs_withdraw of the builder"
    bad, kinds = list(lanes), {}
    for j, lane in enumerate(sorted(rng.sample(range(WITHDRAW_LANES), 64))):
        kinds[lane] = withdraw_cases.TAMPERS[j % len(withdraw_cases.TAMPERS)]
        bad[lane] = withdraw_cases.tamper(lanes[lane], kinds[lane], N_LEVELS)
    reserved = kept_memory()
    hashes_bad, ok_bad, launches_bad = run_counted(bad)
    wide_kept = kept_memory() - reserved
    graph = engine.calls[WITHDRAW_LANES]
    assert graph.replays == 1 and graph.counts == launches == launches_bad
    assert np.flatnonzero(~ok_bad).tolist() == sorted(kinds), \
        "the refused lanes are not the tampered ones"
    assert hashes_bad == [hash_inputs_withdraw(d) for d in bad]
    print(f"Withdraw({N_LEVELS}) x {WITHDRAW_LANES} lanes on "
          f"{torch.cuda.get_device_name(0)}: every ok True, every hash EXACT "
          f"vs builder; {len(kinds)} tampered lanes "
          f"({', '.join(withdraw_cases.TAMPERS)}) and only those refused; "
          f"launches={launches} (op by op) and {launches_bad} (the graph's "
          f"kernel nodes, {graph.nodes} nodes, captured in "
          f"{sum(graph.seconds.values()):.3f} s, its pool and static inputs "
          f"{wide_kept / 2**20:.1f} MiB); sha256_chain's narrow route "
          f"ends at {edge} lanes, so this was its wide route", flush=True)

    # one lane, the reference circuit's own shape: K4's narrow route
    reserved, each = kept_memory(), []
    for kind in (None,) + withdraw_cases.TAMPERS:
        one = lanes[7] if kind is None else \
            withdraw_cases.tamper(lanes[7], kind, N_LEVELS)
        h1, ok1, launches1 = run_counted([one])
        assert h1 == [hash_inputs_withdraw(one)], kind
        assert bool(ok1[0]) == (kind is None), kind
        each.append(launches1)
    grown = kept_memory() - reserved
    assert engine.calls[1].replays == len(withdraw_cases.TAMPERS)
    assert all(c == launches1 for c in each), each
    print(f"Withdraw({N_LEVELS}) x 1 lane (sha256_chain's narrow route): ok "
          f"and hash EXACT vs builder, each tamper refused, the first op by "
          f"op, the second captured, the rest replays; launches={launches1} "
          f"a batch; its graph ({engine.calls[1].nodes} nodes) in the pool "
          f"of the {WITHDRAW_LANES}-lane one: reserved memory grew "
          f"{grown / 2**20:.1f} MiB with it", flush=True)

    # the path's K1 and K4 calls, then its times
    t0 = time.perf_counter()
    packed = engine.pack(lanes)
    sync()
    t_pack = time.perf_counter() - t0
    k1, chain_calls, k4 = record_calls(
        lambda: engine.run_packed_eager(packed))
    print("Withdraw path's Poseidon calls (t, lanes) x count: "
          + ", ".join(f"{k} x {v}" for k, v in sorted(k1.items()))
          + "; SHA-256 calls (blocks, lanes) x count: "
          + ", ".join(f"{k} x {v}" for k, v in sorted(k4.items())),
          flush=True)
    assert not set(POSEIDON_WITHDRAW) - set(k1), k1
    assert sum(k1.values()) == launches["poseidon_permute"]
    assert k4 == {(SHA_WITHDRAW[1], WITHDRAW_LANES): 1} and not chain_calls

    def batch():
        h, k = engine.run_packed(packed)
        return h.cpu(), k

    reps = [plain_ms(batch) * 1e-3 for _ in range(5)]
    steady = statistics.median(reps)
    p = packed
    zero = torch.zeros_like(p["idx"])
    on = torch.ones((WITHDRAW_LANES,), dtype=torch.bool, device=dev)
    state = hash_state(p["token_id"], zero, p["sign"], p["balance"],
                       p["ay"], p["eth_addr"])
    layers = {
        "state hash": lambda: hash_state(
            p["token_id"], zero, p["sign"], p["balance"], p["ay"],
            p["eth_addr"]),
        "verifier": lambda: smt.verifier(
            on, p["root_exit"], p["siblings_state"], zero, zero, ~on,
            p["idx"], state, ~on),
        "its two leaf hashes": lambda: (smt.smt_hash1(p["idx"], state),
                                        smt.smt_hash1(zero, zero)),
        "hash": lambda: hash_inputs.hash_inputs_withdrawal(
            N_LEVELS, p["root_exit"], p["eth_addr"], p["token_id"],
            p["balance"], p["idx"]),
    }
    t_layer = {k: median_s(fn) for k, fn in layers.items()}
    loop = t_layer["verifier"] - t_layer["its two leaf hashes"]
    print(f"Withdraw times on {card}: pack {t_pack:.3f} s, first run (pack "
          f"and unpack included) {t_first:.3f} s, run_packed median "
          f"{steady:.4f} s over 5 runs {['%.4f' % r for r in reps]} "
          f"({WITHDRAW_LANES / steady:.1f} withdrawals/s); layers, median of "
          "5 each: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in t_layer.items())
          + f"; so the verifier's loop over {N_LEVELS + 1} levels takes about "
          f"{loop:.4f} s", flush=True)

    # what one launch of K2 would take for that loop: the verifier's chain
    # is the processor's old chain with masks (top, 0, 0, 0, at) and the
    # leaf as old1leaf
    top, at = smt.verifier_states(p["siblings_state"])
    off = torch.zeros_like(top)
    leaf = smt.smt_hash1(p["idx"], state).contiguous()
    cargs = (torch.flip(p["siblings_state"], dims=[0]).contiguous(),
             torch.flip(fr.bits_le(p["idx"], N_LEVELS + 1), dims=[0]
                        ).contiguous(),
             torch.flip(torch.stack([top, off, off, off, at], dim=1),
                        dims=[0]).long().contiguous(),
             leaf, leaf, leaf)
    kernels.reset_launches()
    old, _ = smt.processor_chain(*cargs)
    sync()
    assert torch.equal(old, p["root_exit"]), \
        "K2's old chain is not the verifier's root"
    hashes_k2, bound_of = smt_bound_of(cargs)
    ms = kernel_ms(lambda: smt.processor_chain(*cargs), 5)
    bound_ms, by = bound(*bound_of)
    print(f"  smt_chain as the verifier's loop (not on any path): n="
          f"{N_LEVELS + 1} B={WITHDRAW_LANES}, old chain == rootExit in every "
          f"lane, {hashes_k2} hashes selected, half of them the new chain's "
          f"that nobody reads; kernel={ms:.4f} ms bound={bound_ms:.4f} ms "
          f"({by})", flush=True)
    return engine, lanes, graph.counts, packed


def tensor_leaves(tree):
    """The tensors of a tree of dicts, tuples and lists, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def same_tree(a, b, what):
    """Two trees of tensors equal key for key and limb for limb."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            same_tree(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{what}[{i}]")
    else:
        assert a.shape == b.shape and torch.equal(a, b), what


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under the tensors of `tree`."""
    seen = {}
    for t in tensor_leaves(tree):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values())


def drive_route(name, call, eager, packed, packed_b, card):
    """One compiled debug route on the production batch A and on B: the
    first call (A, op by op, the warm-up), the capture at the second (B,
    with its replay), a replay of A. The graph's kernel nodes, read from the
    graph, must be the first call's wrapper launches; B and A replayed must
    equal the eager route limb for limb. Then both routes timed (replay
    median of 5, eager median of 3). Returns (A, B) replayed."""
    mib = 2.0 ** 20
    assert not call.warm and call.outputs is None, name
    kernels.reset_launches()
    t0 = time.perf_counter()
    first = call(packed)
    sync()
    t_first = time.perf_counter() - t0
    launches = dict(kernels.launches)
    kernels.reset_launches()
    reserved = kept_memory()
    t0 = time.perf_counter()
    out_b = call(packed_b)
    sync()
    t_capture = time.perf_counter() - t0
    after = kept_memory()
    assert not any(kernels.launches.values()), (name, kernels.launches)
    assert call.counts == launches, (name, call.counts, launches)
    out_a = call(packed)
    same_tree(out_a, first, f"{name}: A replayed vs A op by op")
    same_tree(out_b, eager(packed_b), f"{name}: B replayed vs eager")
    eager_t, eager_mem = route_times(lambda: eager(packed), reps=3)
    graph_t, graph_mem = route_times(lambda: call(packed))
    replay, eager_s = statistics.median(graph_t), statistics.median(eager_t)
    print(f"  {name}: first call (op by op) {t_first:.3f} s, wrapper "
          f"launches {launches}; capture at the second call "
          f"{t_capture:.3f} s with its replay ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in call.seconds.items())
          + f"), {call.nodes} nodes, kernel nodes {call.counts} == the first "
          f"call's launches; A, B, A replayed == op by op; replay median "
          f"{replay:.4f} s {['%.4f' % t for t in graph_t]} "
          f"(max_memory_allocated {graph_mem / mib:.1f} MiB), eager median "
          f"{eager_s:.4f} s {['%.4f' % t for t in eager_t]} "
          f"(max_memory_allocated {eager_mem / mib:.1f} MiB); reserved "
          f"{reserved / mib:.1f} -> {after / mib:.1f} MiB over the capture "
          f"(+{(after - reserved) / mib:.1f}, the shared pool's growth and "
          f"the static outputs in it); static outputs "
          f"{storage_bytes(call.outputs) / mib:.1f} MiB, static inputs "
          f"{storage_bytes(call.inputs) / mib:.1f} MiB; on {card}",
          flush=True)
    return out_a, out_b


def check_debug_paths(engine, inp, bad, out, bb_a, bb_b, wengine, wlanes,
                      wpacked, card):
    """Phase 9: the engine's one compiled debug route, `debug_call`, on
    the production batch, driven by `drive_route`; then every entry point
    that reads it -- `_full_debug`, `trace` / `get_signal` and
    `check_batch`, whose engine `engine` is -- as a replay; the engine's
    two graphs replayed in turns out of its one pool; `export_witness` at
    this shape; the witness vectors at a smaller depth; Withdraw's
    `run_debug` on phase 8's lanes. Returns each debug graph's kernel nodes
    by kernel."""
    n_tx, _, _, max_fee = engine.params
    assert checker.engine_for(engine.params, engine.device) is engine
    call = engine.debug_call
    packed, packed_b = engine.pack(inp), engine.pack(bb_b.get_input())
    mib = 2.0 ** 20
    print(f"compiled debug route on RollupMain{engine.params} (A the "
          "production batch, B phase 13's second one):", flush=True)
    debug_a, debug_b = drive_route("debug_call", call, engine.debug_eager,
                                   packed, packed_b, card)

    # the entry points, each one replay of debug_call: no wrapper runs
    kernels.reset_launches()
    replays = call.replays
    t0 = time.perf_counter()
    lanes, lane_ok, dout, ok = engine._full_debug(inp)
    assert bool(ok) and bool(lane_ok.all())
    assert engine.unpack_outputs(dout) == out, "_full_debug != run"
    _, _, dout_b, ok_b, _ = debug_b
    assert bool(ok_b)
    want_b = {"hash_global_inputs": bb_b.get_hash_inputs(),
              "new_state_root": bb_b.get_new_state_root(),
              "new_exit_root": bb_b.get_new_exit_root(),
              "new_last_idx": bb_b.get_new_last_idx()}
    got_b = engine.unpack_outputs(dout_b)
    assert {k: got_b[k] for k in want_b} == want_b, "_full_debug(B)"
    t_debug = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = engine.trace(inp)
    assert set(tr) == set(engine.SIGNALS) | {"lane_ok", "accFeeOut"}
    assert tr["lane_ok"] == [True] * n_tx
    assert tr["decode.fromIdx"] == [int(v) for v in inp["fromIdx"]]
    roots = [int(v) for v in inp["imStateRoot"]] \
        + [int(inp["imInitStateRootFee"])]
    assert tr["newStateRoot"] == roots
    assert engine.get_signal(inp, f"newStateRoot[{n_tx - 1}]") == roots[-1]
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = check_batch(engine.pack(bad), *engine.params)
    assert not res["ok"]
    assert np.flatnonzero(~res["lane_ok"]).tolist() == [5], \
        "check_batch does not name the tampered lane alone"
    assert res["fee_ok"].all() and res["fee_ok"].shape == (max_fee,)
    assert check_batch(packed, *engine.params)["ok"]
    t_check = time.perf_counter() - t0
    assert not any(kernels.launches.values()), kernels.launches
    assert call.replays == replays + 5, (call.replays, replays)
    print(f"entry points through debug_call (5 replays, no wrapper called): "
          f"_full_debug == run and the builder's hash and roots on A and B "
          f"({t_debug:.3f} s); trace: lane_ok all True, decode.fromIdx and "
          f"the chain of newStateRoot as the builder's input, get_signal one "
          f"lane ({t_trace:.3f} s for both, host reads included); "
          f"check_batch on phase 5's tampered batch: lane 5 alone, fee_ok "
          f"all True, then A passes ({t_check:.3f} s for both)", flush=True)

    # the engine's two graphs in turns out of its one pool, each exact
    main_a, main_ok = engine.run_packed(packed)
    assert bool(main_ok) and bool(debug_a[3])
    same_tree(main_a, {k: debug_a[2][k] for k in main_a},
              "the main graph vs debug_call's outputs")
    refs = {"main": (main_a, main_ok), "debug_call": debug_a}
    routes = {"main": lambda: engine.run_packed(packed),
              "debug_call": lambda: call(packed)}
    for name in ("main", "debug_call", "main"):
        same_tree(routes[name](), refs[name], f"interleaved {name}")
    assert engine.call.pool is call.pool is not None
    print(f"shared pool: the main graph, debug_call, the main graph "
          f"replayed in turns, each exact; reserved memory "
          f"{kept_memory() / mib:.1f} MiB with the engine's two graphs",
          flush=True)

    # the witness vector at this shape, through the replayed debug_call:
    # the pack and the replay timed apart from the gather, the copy and the
    # read as ints
    stage_s = {"pack": [], "debug_call": []}

    def timed(name):
        real = getattr(engine, name)

        def call(*args):
            t0 = time.perf_counter()
            res = real(*args)
            sync()
            stage_s[name].append(time.perf_counter() - t0)
            return res
        return call

    # `debug_call` is the engine's own attribute, `pack` its class's method
    own = {name: engine.__dict__.get(name) for name in stage_s}
    for name in stage_s:
        setattr(engine, name, timed(name))
    try:
        t0 = time.perf_counter()
        names, values = witness_vector.export_witness(engine, inp)
        t_export = time.perf_counter() - t0
    finally:
        for name, real in own.items():
            if real is None:
                delattr(engine, name)
            else:
                setattr(engine, name, real)
    pack_s, device_s = stage_s["pack"], stage_s["debug_call"]
    assert len(pack_s) == 1
    assert len(device_s) == 1 and len(names) == len(values)
    assert values[1] == bb_a.get_hash_inputs()
    w = dict(zip(names, values))
    assert w["main.newStateRoot"] == bb_a.get_new_state_root()
    assert w["main.newLastIdx"] == bb_a.get_new_last_idx()
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        wtns = os.path.join(tmp, "w.wtns")
        t0 = time.perf_counter()
        witness_vector.write_wtns(wtns, values)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(wtns)
        # the handoff: the same bytes, gathered on the card and written
        # from the pinned buffer
        handed = os.path.join(tmp, "h.wtns")
        t0 = time.perf_counter()
        out_h, ok_h = witness_vector.handoff(engine, inp, handed)
        t_handoff = time.perf_counter() - t0
        assert ok_h and filecmp.cmp(wtns, handed, shallow=False), "handoff"
        assert out_h["hash_global_inputs"] == bb_a.get_hash_inputs()
    assert size == 12 + 12 + 40 + 12 + 32 * len(values)
    print(f"export_witness of RollupMain{engine.params} on {card}: "
          f"{len(values)} signals, {t_export:.3f} s = pack {pack_s[0]:.3f} "
          f"s + debug_call replayed {device_s[0]:.3f} s + the gather, the "
          f"copy and the read as ints "
          f"{t_export - pack_s[0] - device_s[0]:.3f} s; write_wtns "
          f"{t_write:.3f} s, {size} bytes; handoff {t_handoff:.3f} s, the "
          f"same bytes; hash, newStateRoot, newLastIdx the builder's",
          flush=True)

    # the witness vectors; their pure-Python checker bounds the depth
    t0 = time.perf_counter()
    bb = production_batch(*EXPORT_CONFIG)
    small = RollupEngine(*EXPORT_CONFIG)
    names, values = witness_vector.export_witness(small, bb.get_input())
    assert names == witness_vector.signal_names(*EXPORT_CONFIG)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        wtns, sym = os.path.join(tmp, "w.wtns"), os.path.join(tmp, "w.sym")
        witness_vector.write_wtns(wtns, values)
        witness_vector.write_sym(sym, names)
        size = os.path.getsize(wtns)
        w = witness_vector.load_witness(wtns, sym)
    assert w == dict(zip(names, values))
    assert w["main.hashGlobalInputs"] == bb.get_hash_inputs()
    assert w["main.newStateRoot"] == bb.get_new_state_root()
    res = verify_witness(w, *EXPORT_CONFIG)
    assert res["ok"], res["failures"][:5]
    w_bad = dict(w)
    w_bad["main.Tx[0].newStHash1"] = (w["main.Tx[0].newStHash1"] + 1) \
        % scalar.P
    assert not verify_witness(w_bad, *EXPORT_CONFIG)["ok"]
    t_verify = time.perf_counter() - t0
    print(f"witness vector of RollupMain{EXPORT_CONFIG} from the card: "
          f"{len(values)} signals, .wtns {size} bytes, export "
          f"{t_export:.1f} s (host build included); verify_witness passes "
          f"({res['n_checked']} relations) and fails with one value changed "
          f"({t_verify:.1f} s)", flush=True)

    t0 = time.perf_counter()
    sub = [dict(d, ethAddr=int(str(d["ethAddr"]), 0))
           for d in wlanes[:EXPORT_WITHDRAW_LANES]]
    names, values = witness_vector.export_witness_withdraw(wengine, sub)
    assert names == witness_vector.signal_names_withdraw(N_LEVELS, len(sub))
    w = dict(zip(names, values))
    res = verify_withdraw_witness(w, N_LEVELS, len(sub))
    assert res["ok"], res["failures"][:5]
    w_bad = dict(w)
    w_bad["main.balance[0]"] += 1
    assert not verify_withdraw_witness(w_bad, N_LEVELS, len(sub))["ok"]
    print(f"witness vector of Withdraw({N_LEVELS}) x {len(sub)} lanes from "
          f"the card: {len(values)} signals; verify_withdraw_witness passes "
          f"({res['n_checked']} relations) and fails with one value changed "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # Withdraw's run_debug at phase 8's width
    n = len(wlanes)
    wcall = wengine.debug_call_for(n)
    bad_w, kinds = list(wlanes), {}
    pick = random.Random(SEED + 9)
    for j, lane in enumerate(sorted(pick.sample(range(n), 64))):
        kinds[lane] = withdraw_cases.TAMPERS[j % len(withdraw_cases.TAMPERS)]
        bad_w[lane] = withdraw_cases.tamper(wlanes[lane], kinds[lane],
                                            N_LEVELS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    hashes, ok, _ = wengine.run_debug(wlanes)
    sync()
    t_first = time.perf_counter() - t0
    launches = dict(kernels.launches)
    assert ok.all() and hashes == [hash_inputs_withdraw(d) for d in wlanes]
    kernels.reset_launches()
    reserved = kept_memory()
    t0 = time.perf_counter()
    hashes, ok, _ = wengine.run_debug(bad_w)
    sync()
    t_capture = time.perf_counter() - t0
    after = kept_memory()
    assert not any(kernels.launches.values()), kernels.launches
    assert wcall.counts == launches, (wcall.counts, launches)
    assert np.flatnonzero(~ok).tolist() == sorted(kinds), \
        "the refused lanes are not the tampered ones"
    assert hashes == [hash_inputs_withdraw(d) for d in bad_w]
    same_tree(wcall(wpacked),
              wengine.run_packed_eager(wpacked, debug=True),
              "Withdraw debug: replayed vs eager")

    eager_t, eager_mem = route_times(
        lambda: wengine.run_packed_eager(wpacked, debug=True), reps=3)
    graph_t, graph_mem = route_times(lambda: wcall(wpacked))
    print(f"Withdraw({N_LEVELS}) x {n} run_debug on {card}: first call (op "
          f"by op, pack included) {t_first:.3f} s, launches {launches}; "
          f"capture at the second {t_capture:.3f} s with its pack and replay "
          "(" + ", ".join(f"{k} {v:.3f} s"
                          for k, v in wcall.seconds.items())
          + f"), {wcall.nodes} nodes, kernel nodes {wcall.counts}; every "
          f"hash the builder's, {len(kinds)} tampered lanes and only those "
          f"refused through the graph; hash, ok and state_hash replayed == "
          f"eager; "
          f"replay median {statistics.median(graph_t):.4f} s "
          f"{['%.4f' % t for t in graph_t]} (max_memory_allocated "
          f"{graph_mem / mib:.1f} MiB), eager median "
          f"{statistics.median(eager_t):.4f} s "
          f"{['%.4f' % t for t in eager_t]} (max_memory_allocated "
          f"{eager_mem / mib:.1f} MiB); reserved {reserved / mib:.1f} -> "
          f"{after / mib:.1f} MiB over the capture; static outputs "
          f"{storage_bytes(wcall.outputs) / mib:.1f} MiB", flush=True)
    return {"debug": call.counts, "withdraw_debug": wcall.counts}


FEE1_CONFIG = (2, 16, 1, 1)  # maxFeeTx = 1: the fee chain has no im pin


def check_fee_of_one(dev, card):
    """Phase 9's check at maxFeeTx = 1, on a valid RollupMain(2, 16, 1, 1)
    batch and on the same batch with the fee recipient's balance3 + 7:
    `check_batch` through its engine's `debug_call` (a fresh one: the valid
    batch op by op, the tampered one captured, then both replayed, each
    replay timed) must
    give `fee_ok` [True], then [False], of shape (1,), and every lane True;
    then `check_batch_sharded` in a world of one over NCCL on both batches
    must give the same masks. A mismatch raises."""
    bb = production_batch(*FEE1_CONFIG)
    valid = bb.get_input()
    bad = dict(valid, balance3=[valid["balance3"][0] + 7])
    want = {"valid": [True], "tampered": [False]}
    packed = {"valid": pack_rollup_inputs(valid, *FEE1_CONFIG, device=dev),
              "tampered": pack_rollup_inputs(bad, *FEE1_CONFIG, device=dev)}
    call = checker.engine_for(FEE1_CONFIG, dev).debug_call
    assert not call.warm and call.outputs is None, "the check is not fresh"

    def checked(case, route, res):
        assert res["fee_ok"].shape == (1,), (route, case, res["fee_ok"])
        assert res["fee_ok"].tolist() == want[case], (route, case, res)
        assert res["lane_ok"].tolist() == [True] * FEE1_CONFIG[0], \
            (route, case, res)
        assert res["ok"] is (case == "valid"), (route, case, res)
        return res

    secs, got = {}, {}
    for step, case in (("op by op", "valid"), ("capture", "tampered"),
                       ("replay", "valid"), ("replay", "tampered")):
        sync()
        t0 = time.perf_counter()
        res = check_batch(packed[case], *FEE1_CONFIG)
        secs[f"{step} {case}"] = time.perf_counter() - t0
        got[case] = checked(case, "check_batch", res)
    # the capture replays once, then two replays
    assert call.outputs is not None and call.replays == 3, call.replays
    replays = route_times(lambda: check_batch(packed["valid"],
                                              *FEE1_CONFIG))[0]
    print(f"check_batch at RollupMain{FEE1_CONFIG}: fee_ok [True] on the "
          f"valid batch, [False] with balance3 + 7, shape (1,), every lane "
          f"True; " + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
          + " (capture: " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in call.seconds.items())
          + f", {call.nodes} nodes); replay median "
          f"{statistics.median(replays):.4f} s over 5 "
          f"{['%.4f' % t for t in replays]}, host reads included; on {card}",
          flush=True)
    mesh = make_tx_mesh(1, device=dev)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        for case in want:
            sync()
            t0 = time.perf_counter()
            res = checked(case, "check_batch_sharded", check_batch_sharded(
                mesh, packed[case], *FEE1_CONFIG))
            secs[case] = time.perf_counter() - t0
            for mask in ("lane_ok", "fee_ok"):
                assert res[mask].tolist() == got[case][mask].tolist(), \
                    (case, mask)
    finally:
        dist.destroy_process_group()
    print(f"check_batch_sharded at RollupMain{FEE1_CONFIG}, a world of one "
          f"over NCCL (op by op): the same masks on both batches, valid "
          f"{secs['valid']:.3f} s, tampered {secs['tampered']:.3f} s; on "
          f"{card}", flush=True)


def check_new_modules(dev, rng):
    """Phase 10: the public point operations and the 8-bit-limb Poseidon
    permutation on the card."""
    n = 1024
    ks = [rng.randrange(babyjub.SUB_ORDER) for _ in range(n)]
    bits = fr.bits_le(fr.pack(ks, dev), babyjubjub.S_BITS)
    b8 = babyjubjub.from_affine_mont(
        fr.to_mont(fr.pack([babyjub.BASE8[0]] * n, dev)),
        fr.to_mont(fr.pack([babyjub.BASE8[1]] * n, dev)))
    babyjubjub.scalar_mul_base8(bits[:, :2])  # warm-up
    base_ms = plain_ms(lambda: babyjubjub.scalar_mul_base8(bits))
    base = babyjubjub.scalar_mul_base8(bits)
    var_ms = plain_ms(lambda: babyjubjub.scalar_mul_var(bits, b8))
    var = babyjubjub.scalar_mul_var(bits, b8)
    eq = babyjubjub.points_equal(var, base)
    n_bad = int((~eq).sum().item())
    x, y, z = (fr.from_mont(c[:, :16]) for c in base)
    zinv = fr.inv(z)
    got = torch.stack([fr.mul(x, zinv), fr.mul(y, zinv)])
    want = [babyjub.mul_point(k, babyjub.BASE8) for k in ks[:16]]
    err = max_err(got.cpu(), torch.stack(
        [fr.pack([w[0] for w in want]), fr.pack([w[1] for w in want])]))
    print(f"  BabyJubJub x {n} lanes: scalar_mul_base8 {base_ms:.1f} ms, "
          f"scalar_mul_var(B8) {var_ms:.1f} ms (plain PyTorch); "
          f"points_equal false on {n_bad} lanes; 16 lanes' affine points "
          f"against the host mul_point: max_abs_err={err}", flush=True)
    assert n_bad == 0 and err == 0, "BabyJubJub point operations disagree"
    lanes = 4096
    for t in range(3, 8):
        vals = [[rng.randrange(scalar.P) for _ in range(lanes)]
                for _ in range(t)]
        st = fr.to_mont(fr.pack(vals, dev)).contiguous()
        want = poseidon.permute_mont(st)
        got = poseidon_mxu.permute_mont_mxu(st)
        err = max_err(got, want)
        k1_ms = kernel_ms(lambda: poseidon.permute_mont(st), 5)
        mxu_ms = plain_ms(lambda: poseidon_mxu.permute_mont_mxu(st))
        print(f"  permute_mont_mxu t={t} x {lanes} lanes: max_abs_err={err} "
              f"against K1; mxu {mxu_ms:.1f} ms (plain PyTorch, float64 "
              f"products), K1 {k1_ms:.4f} ms", flush=True)
        assert err == 0, f"permute_mont_mxu t={t} disagrees with K1"


def check_cli(card):
    """Phase 11: every CLI verb that runs the engine, each in its own
    process on the card, in a temporary directory. The five verbs that only
    read `inputs-32.json` run side by side; `compile`, the warm start, runs
    alone. `audit` is left out: it reads circom sources and prints text on
    the host, and does nothing on the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    params = ["32", "16", "8", "64"]
    secs, outs = {}, {}

    def cli(*calls):
        """Run (tag, exit code wanted, argv) calls side by side, their
        output into files; keep each one's stdout and seconds."""
        procs, t0 = {}, time.perf_counter()
        try:
            for tag, code, args in calls:
                with open(os.path.join(tmp, f"{tag}.out"), "w") as out, \
                        open(os.path.join(tmp, f"{tag}.err"), "w") as err:
                    procs[tag] = (code, args, subprocess.Popen(
                        [sys.executable, "-m", "circuits_tpu_torch.tools.cli",
                         *args], cwd=tmp, env=env, stdout=out, stderr=err))
            while len(secs.keys() & procs.keys()) < len(procs):
                assert time.perf_counter() - t0 < 300, "a CLI verb hangs"
                for tag, (_, _, proc) in procs.items():
                    if tag not in secs and proc.poll() is not None:
                        secs[tag] = time.perf_counter() - t0
                time.sleep(0.02)
        finally:
            for _, _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        for tag, (code, args, proc) in procs.items():
            with open(os.path.join(tmp, f"{tag}.out")) as f:
                outs[tag] = f.read()
            with open(os.path.join(tmp, f"{tag}.err")) as f:
                err = f.read()
            assert proc.returncode == code, (
                f"cli {' '.join(args)}: exit {proc.returncode}, wanted "
                f"{code}\n{outs[tag][-2000:]}{err[-4000:]}")

    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        cli(("create", 0, ["create", *params]))
        assert os.path.exists(os.path.join(tmp, "rollup-32-16-8-64",
                                           "config.json"))
        cli(("input", 0, ["input", "32", "16"]))
        expected = outs["input"].strip().rsplit("= ", 1)[1].rstrip(")")
        inp = os.path.join(tmp, "inputs-32.json")
        with open(inp) as f:
            bad = json.load(f)
        bad["balance1"][0] = str(int(bad["balance1"][0]) + 7)
        with open(os.path.join(tmp, "bad.json"), "w") as f:
            json.dump(bad, f)
        cli(("witness", 0, ["witness", inp, "out.json", *params]),
            ("check", 0, ["check", inp, *params]),
            ("check tampered", 1, ["check", "bad.json", *params]),
            ("trace", 0, ["trace", inp, *params, "decode.tokenID"]),
            ("witnessfull", 0, ["witnessfull", inp, "full.wtns", *params]))
        with open(os.path.join(tmp, "out.json")) as f:
            res = json.load(f)
        cli(("compile", 0, ["compile", "2048", "32", "256", "64"]))
    assert res["ok"] is True, res
    assert res["outputs"]["hash_global_inputs"] == expected
    assert outs["check"].strip() == "constraints SATISFIED", outs["check"]
    assert outs["check tampered"].strip() == "constraints FAILED"
    traced = json.loads(outs["trace"].strip().splitlines()[-1])
    assert traced["decode.tokenID"] == ["1"] * 16 + ["0"] * 16, traced
    assert "ALL SATISFIED" in outs["witnessfull"], outs["witnessfull"]
    print(f"  CLI on {card}: input printed hashGlobalInputs = {expected}; "
          "witness ok and the same hash, check 0 and 1 (tampered), trace "
          "and witnessfull 0 (ALL SATISFIED)", flush=True)
    print("  " + outs["compile"].strip().replace("\n", "\n  "), flush=True)
    print("  seconds a verb, its own process (witness, check, check "
          "tampered, trace and witnessfull side by side): " + ", ".join(
              f"{k} {v:.1f}" for k, v in secs.items()), flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_sharded(engine, packed, bb, bad, card):
    """Phase 12: the tx-lane sharded path on phase 4's batch. (a) A world
    of one over NCCL in this process: outputs limb-equal to `run_packed`,
    the hash to the builder's, every kernel of the main path launched,
    timed as a median of 3. (b) A world of two: two `multihost_worker`
    processes on this one card over gloo (NCCL refuses two ranks on one
    card), fed one batch file, which they run twice (a first call, then
    one more): every hash the builder's, each rank's launches and seconds
    printed; `check_batch_sharded` on a copy with lanes 5 and 1024
    (the first lane of rank 1) tampered names exactly those two lanes.
    Returns the kernels' launches of (a)'s run."""
    n_tx = engine.params[0]
    dev = engine.device
    mesh = make_tx_mesh(1, device=dev)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        run = make_sharded_rollup_main(mesh, *engine.params)
        want, _ = engine.run_packed(packed)
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out, ok = run(packed)
        sync()
        t_first = time.perf_counter() - t0
        launches = dict(kernels.launches)
        assert bool(ok), "the sharded path refused a valid batch"
        for k in want:
            assert torch.equal(out[k], want[k]), f"{k}: sharded != run_packed"
        assert fr.unpack_int(out["hash_global_inputs"]) == \
            bb.get_hash_inputs()
        for name in kernels.MAIN_PATH:
            assert launches[name] > 0, \
                f"kernel {name} was not launched by the sharded path"

        def timed():
            o, k = run(packed)
            assert bool(k) and fr.unpack_int(o["hash_global_inputs"].cpu()) \
                == bb.get_hash_inputs()

        reps = [plain_ms(timed) * 1e-3 for _ in range(3)]
    finally:
        dist.destroy_process_group()
    print(f"world of one (NCCL, in process) on {card}: outputs == "
          f"run_packed, hash == builder, launches {launches}; first call "
          f"{t_first:.3f} s, median {statistics.median(reps):.4f} s over 3 "
          f"runs {['%.4f' % r for r in reps]}", flush=True)

    bad = dict(bad)
    bad["s"] = list(bad["s"])
    bad["s"][n_tx // 2] = (bad["s"][n_tx // 2] + 1) % scalar.P
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "batches.pt")
        multihost_worker.write_batches(path, engine.params,
                                       [packed, packed], [engine.pack(bad)])
        port, procs, t0 = free_port(), [], time.perf_counter()
        try:
            for rank in range(2):
                with open(os.path.join(tmp, f"{rank}.out"), "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "circuits_tpu_torch.scripts.multihost_worker",
                         str(rank), "2", str(port), path, "--backend",
                         "gloo"], cwd=root, env=env, stdout=f,
                        stderr=subprocess.STDOUT))
            while any(p.poll() is None for p in procs):
                assert time.perf_counter() - t0 < 300, "a rank hangs"
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        t_world2 = time.perf_counter() - t0
        outs = []
        for rank in range(2):
            with open(os.path.join(tmp, f"{rank}.out")) as f:
                outs.append(f.read())
    ranks = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        line = [ln for ln in out.splitlines()
                if ln.startswith("MULTIHOST_RESULT ")][0]
        ranks.append(json.loads(line.split(" ", 1)[1]))
    for rank, res in enumerate(ranks):
        (run, again), check = res["runs"], res["checks"][0]
        assert res["rank"] == rank and res["device"] == "cuda:0", res["device"]
        for r in (run, again):
            assert r["ok"] and r["hash"] == bb.get_hash_inputs(), rank
        assert not check["ok"]
        assert np.flatnonzero(~np.array(check["lane_ok"])).tolist() \
            == [5, n_tx // 2], f"rank {rank} names the wrong lanes"
        assert all(check["fee_ok"])
        assert all(run["launches"][k] > 0 for k in kernels.MAIN_PATH), \
            f"rank {rank} launched {run['launches']}"
        print(f"  rank {rank} of 2 (gloo, cuda:0, lanes "
              f"{rank * n_tx // 2}-{(rank + 1) * n_tx // 2 - 1}): hash == "
              f"builder, its first batch {run['seconds']:.3f} s, the second "
              f"{again['seconds']:.3f} s, launches {again['launches']}; "
              f"check_batch_sharded on the tampered copy names lanes 5 and "
              f"{n_tx // 2} alone ({check['seconds']:.3f} s)", flush=True)
    print(f"world of two (two processes on one card over gloo): "
          f"{t_world2:.1f} s for both processes, start-up included",
          flush=True)
    return launches


def capture_engine(engine, packed, launches, bb):
    """Phase 4's capture of RollupMain: the engine's second batch, which
    captures the graph and replays it, timed, with the most memory it held
    at once and what stays reserved after it (the graph's private pool; the
    caching allocator's free blocks are returned before and after). The
    graph's kernel nodes, read from the graph, must be `launches`, the
    first batch's; the capture's wrapper calls and a replay add nothing to
    `kernels.launches`."""
    call = engine.call
    assert call.warm and call.outputs is None
    reserved = kept_memory()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, ok = engine.run_packed(packed)
    sync()
    seconds = time.perf_counter() - t0
    stats = dict(seconds=seconds, steps=call.seconds, nodes=call.nodes,
                 counts=call.counts, peak=torch.cuda.max_memory_allocated(),
                 pool=kept_memory() - reserved)
    assert not any(kernels.launches.values()), kernels.launches
    assert call.counts == launches, (call.counts, launches)
    again, ok_again = engine.run_packed(packed)
    sync()
    assert call.replays == 2 and not any(kernels.launches.values())
    assert bool(ok) and bool(ok_again)
    for k in out:
        assert torch.equal(out[k], again[k]), k
    assert fr.unpack_int(out["hash_global_inputs"]) == bb.get_hash_inputs()
    print(f"captured RollupMain{engine.params} as a CUDA graph of "
          f"{stats['nodes']} nodes at its second batch, {seconds:.3f} s with "
          "that batch's replay ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in call.seconds.items())
          + f"); its kernel nodes {call.counts}, the first batch's launches; "
          "a replay called no wrapper", flush=True)
    return stats


def route_times(run, reps=5):
    """`reps` synchronised runs of `run()`, which ends in a host copy; the
    seconds of each, and the most memory allocated at once over them."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        times.append(time.perf_counter() - t0)
    return times, torch.cuda.max_memory_allocated()


def check_captured(engine, packed, bb, bb_b, bad, captured, wengine,
                   wlanes, wpacked, rng, card):
    """Phase 13: the captured engines against the eager route and the
    builder, A/B/A replays, the tampered batches through the graphs, and
    both routes' times and memory."""
    gib = 2.0 ** 30

    def same(a, b, what):
        assert sorted(a) == sorted(b), what
        for k in b:
            assert torch.equal(a[k], b[k]), f"{what}: {k}"

    def builder_equal(out, batch, what):
        got = engine.unpack_outputs(out)
        assert got["hash_global_inputs"] == batch.get_hash_inputs(), what
        assert got["new_state_root"] == batch.get_new_state_root(), what
        assert got["new_exit_root"] == batch.get_new_exit_root(), what
        assert got["new_last_idx"] == batch.get_new_last_idx(), what

    # A, B, A: graph against eager and builder, replays exact
    packed_b = engine.pack(bb_b.get_input())
    a1, ok_a1 = engine.run_packed(packed)
    b, ok_b = engine.run_packed(packed_b)
    a2, ok_a2 = engine.run_packed(packed)
    assert bool(ok_a1) and bool(ok_b) and bool(ok_a2)
    eager_a, ok_ea = engine.run_packed_eager(packed)
    eager_b, ok_eb = engine.run_packed_eager(packed_b)
    assert bool(ok_ea) and bool(ok_eb)
    same(a1, eager_a, "A, graph vs eager")
    same(b, eager_b, "B, graph vs eager")
    same(a2, a1, "A again")
    assert a1["hash_global_inputs"].data_ptr() != \
        a2["hash_global_inputs"].data_ptr()
    builder_equal(a1, bb, "A")
    builder_equal(b, bb_b, "B")
    assert engine.unpack_outputs(a1) != engine.unpack_outputs(b)
    _, ok_bad = engine.run_packed(engine.pack(bad))
    assert not bool(ok_bad), "the graph accepted the tampered batch"
    print(f"RollupMain{engine.params} graph: A, B, A and eager A, B limb for "
          f"limb equal, A and B exact vs builder, the tampered batch "
          "refused", flush=True)

    # both routes' times and memory
    def graph_run():
        o, k = engine.run_packed(packed)
        assert bool(k) and fr.unpack_int(o["hash_global_inputs"].cpu()) \
            == bb.get_hash_inputs()

    def eager_run():
        o, k = engine.run_packed_eager(packed)
        assert bool(k) and fr.unpack_int(o["hash_global_inputs"].cpu()) \
            == bb.get_hash_inputs()

    eager_t, eager_mem = route_times(eager_run)
    graph_t, graph_mem = route_times(graph_run)
    n_tx = engine.params[0]
    print(f"RollupMain{engine.params} on {card}: capture "
          f"{captured['seconds']:.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in captured["steps"].items())
          + f"), {captured['nodes']} nodes; max_memory_allocated over the "
          f"capture {captured['peak'] / gib:.3f} GiB, the graph's pool "
          f"reserved {captured['pool'] / gib:.3f} GiB; run_packed median "
          f"graph {statistics.median(graph_t):.4f} s "
          f"{['%.4f' % t for t in graph_t]} "
          f"({n_tx / statistics.median(graph_t):.1f} tx/s, "
          f"max_memory_allocated {graph_mem / gib:.3f} GiB), eager "
          f"{statistics.median(eager_t):.4f} s "
          f"{['%.4f' % t for t in eager_t]} "
          f"({n_tx / statistics.median(eager_t):.1f} tx/s, "
          f"max_memory_allocated {eager_mem / gib:.3f} GiB)", flush=True)

    # Withdraw: the graph against eager and builder, tampered lanes
    lanes = len(wlanes)
    wgraph = wengine.compile(lanes)
    bad_w, kinds = list(wlanes), {}
    for j, lane in enumerate(sorted(rng.sample(range(lanes), 64))):
        kinds[lane] = withdraw_cases.TAMPERS[j % len(withdraw_cases.TAMPERS)]
        bad_w[lane] = withdraw_cases.tamper(wlanes[lane], kinds[lane],
                                            N_LEVELS)
    wbad = wengine.pack(bad_w)
    for what, p in (("valid", wpacked), ("tampered", wbad)):
        h, ok = wengine.run_packed(p)
        he, oke = wengine.run_packed_eager(p)
        assert torch.equal(h, he) and torch.equal(ok, oke), what
    h, ok = wengine.run_packed(wbad)
    assert np.flatnonzero(~fr.to_numpy(ok)).tolist() == sorted(kinds)
    assert [int(v) for v in fr.unpack_np(h)] == \
        [hash_inputs_withdraw(d) for d in bad_w]

    def wrun(fn):
        def run():
            hh, kk = fn(wpacked)
            hh.cpu()
            assert bool(kk.all())
        return run

    weager_t, weager_mem = route_times(wrun(wengine.run_packed_eager))
    wgraph_t, wgraph_mem = route_times(wrun(wengine.run_packed))
    print(f"Withdraw({N_LEVELS}) x {lanes} on {card}: graph == eager on the "
          f"valid and the tampered batch, {len(kinds)} tampered lanes and "
          f"only those refused through the graph; capture "
          f"{sum(wgraph.seconds.values()):.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in wgraph.seconds.items())
          + f"), {wgraph.nodes} nodes; run_packed median graph "
          f"{statistics.median(wgraph_t):.4f} s "
          f"{['%.4f' % t for t in wgraph_t]} "
          f"({lanes / statistics.median(wgraph_t):.1f} withdrawals/s, "
          f"max_memory_allocated {wgraph_mem / gib:.3f} GiB), eager "
          f"{statistics.median(weager_t):.4f} s "
          f"{['%.4f' % t for t in weager_t]} "
          f"({lanes / statistics.median(weager_t):.1f} withdrawals/s, "
          f"max_memory_allocated {weager_mem / gib:.3f} GiB)", flush=True)


def production_batch(n_tx, n_levels, max_l1, max_fee, step=1, amount=1000):
    """The scripts/exp_production.py recipe: populate n_tx accounts with
    L1 deposits, then one batch of n_tx signed L2 transfers (a ring, each
    account paying `amount` to the one `step` places on) with one fee
    token."""
    accounts = [HermezAccount(i + 1) for i in range(n_tx)]
    db = RollupDB()
    added = 0
    while added < n_tx:
        bb = db.build_batch(n_tx, n_levels, max_l1, max_fee)
        for acc in accounts[added:added + max_l1]:
            bb.add_tx(dict(fromIdx=0,
                           loadAmountF=float40.fix2float(10_000_000),
                           tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                           fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))
            added += 1
        bb.build()
        db.consolidate(bb)
    bb = db.build_batch(n_tx, n_levels, max_l1, max_fee)
    bb.add_token(1)
    bb.add_fee_idx(256)
    for i in range(n_tx):
        tx = dict(fromIdx=256 + i, toIdx=256 + ((i + step) % n_tx),
                  tokenID=1, amount=amount, userFee=126, nonce=0, onChain=0)
        accounts[i].sign_tx(tx)
        bb.add_tx(tx)
    bb.build()
    return bb


def ptxas_report() -> None:
    """Registers, spills and shared memory of every kernel, as
    `nvcc -Xptxas -v` printed them during this build."""
    entry, spills = None, ""
    for line in kernels.build_log().splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "spill" in line:
            spills = line
        elif entry and line.startswith("ptxas info") and "Used" in line:
            print(f"  {entry}: {line.split(':', 1)[1].strip()}; {spills}",
                  flush=True)
            entry = None


def measure_rates(dev) -> None:
    """Fill `rates`: the card's sustained `fr_mont_mul` rate (the best of
    1, 2 and 4 independent chains a thread, 8 blocks of 256 threads an SM)
    and its maximum SM clock; print the rate beside the figure reckoned
    from the int32 instruction rate, and the time of one product in a chain of
    dependent ones with one and with two warps a scheduler, which is what
    a small batch sees."""
    so = kernels.lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty((8 * sms * 256,), dtype=torch.int32, device=dev)

    def ms_of(chains, blocks, threads, iters):
        def fn():
            kernels.check(so.ctpu_mont_rate(
                kernels.ptr(out), chains, blocks, threads, iters,
                kernels.stream_ptr(dev)), "ctpu_mont_rate")

        fn()
        sync()
        return kernel_ms(fn, 5)

    found = {c: 2048 * 8 * sms * 256 / (ms_of(c, 8 * sms, 256, 2048 // c)
                                        * 1e-3) for c in (1, 2, 4)}
    rates["mont_mul"] = max(found.values())
    # one block an SM: 128 threads leave a scheduler one warp, 256 two
    chain_ns = [ms_of(1, sms, threads, 2048) * 1e6 / 2048
                for threads in (128, 256)]
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    rates["chain_ns"] = chain_ns[0]
    rates["clock_hz"] = float(res.stdout.strip().splitlines()[0]) * 1e6
    reckoned = (INT32_LANES_PER_SM * sms * rates["clock_hz"] / MONT_MUL_SLOTS)
    print("fr_mont_mul rate: measured "
          + ", ".join(f"{r:.4e}/s at {c} chains a thread"
                      for c, r in found.items())
          + f"; best {rates['mont_mul']:.4e}/s; reckoned {reckoned:.4e}/s "
          f"({INT32_LANES_PER_SM} int32 lanes x {sms} SMs x "
          f"{rates['clock_hz'] / 1e6:.0f} MHz / {MONT_MUL_SLOTS} slots a "
          f"product); one product of a dependent chain: {chain_ns[0]:.1f} "
          f"ns with one warp a scheduler, {chain_ns[1]:.1f} ns with two",
          flush=True)


def main() -> None:
    # 1 - the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = exp_mxu_inkernel.card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda", 0)
    rng = random.Random(SEED)

    # 2 - build
    t0 = time.perf_counter()
    kernels.build()
    kernels.prepare(dev)
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({kernels.library_path().name})", flush=True)
    ptxas_report()
    measure_rates(dev)

    # 3 - each kernel against its plain version
    print("kernel checks (exact):", flush=True)
    check_poseidon(dev, rng)
    check_smt(dev, rng)
    check_eddsa(dev, rng)
    check_ay_sign(dev, rng)
    check_sha(dev, rng)

    # 4 - the production batch through the engine
    n_tx, max_l1, max_fee = 2048, 256, 64
    t0 = time.perf_counter()
    bb = production_batch(n_tx, N_LEVELS, max_l1, max_fee)
    inp = bb.get_input()
    t_host = time.perf_counter() - t0
    # on the card; the engine that check_batch reads too (phase 9)
    engine = checker.engine_for((n_tx, N_LEVELS, max_l1, max_fee), dev)
    t0 = time.perf_counter()
    packed = engine.pack(inp)
    sync()
    t_pack = time.perf_counter() - t0

    kernels.reset_launches()
    t0 = time.perf_counter()
    out, ok = engine.run(inp)  # the engine's first batch: op by op
    sync()
    t_first = time.perf_counter() - t0
    launches = dict(kernels.launches)
    print(f"RollupMain({n_tx}, {N_LEVELS}, {max_l1}, {max_fee}) on "
          f"{torch.cuda.get_device_name(0)}: ok={ok} launches={launches}",
          flush=True)
    assert ok, "engine flagged a constraint failure on a valid batch"
    assert out["hash_global_inputs"] == bb.get_hash_inputs()
    assert out["new_state_root"] == bb.get_new_state_root()
    assert out["new_exit_root"] == bb.get_new_exit_root()
    assert out["new_last_idx"] == bb.get_new_last_idx()
    print("hashGlobalInputs, roots, newLastIdx: EXACT vs builder", flush=True)
    for name in kernels.MAIN_PATH:
        assert launches[name] > 0, \
            f"kernel {name} was not launched by the main path"
    captured = capture_engine(engine, packed, launches, bb)
    check_main_path_calls(dev, engine, packed)

    # 5 - a tampered signature scalar flips the verdict
    bad = dict(inp)
    bad["s"] = list(inp["s"])
    bad["s"][5] = (bad["s"][5] + 1) % scalar.P
    _, ok_bad = engine.run(bad)
    assert not ok_bad, "tampered batch was accepted"
    print("tampered s: ok=False", flush=True)

    # 6 - steady state: pack once, median of 5 synchronised runs
    reps = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        o, k = engine.run_packed(packed)
        sync()
        h = o["hash_global_inputs"].cpu()
        reps.append(time.perf_counter() - t0)
        assert bool(k) and fr.unpack_int(h) == bb.get_hash_inputs()
    steady = statistics.median(reps)
    print(f"times on {card}: host build {t_host:.3f} s, pack {t_pack:.3f} s, "
          f"first call {t_first:.3f} s, steady state median "
          f"{steady:.4f} s over 5 runs {['%.4f' % r for r in reps]} "
          f"({n_tx / steady:.1f} tx/s)", flush=True)

    # 7 - the full-round experiment
    t0 = time.perf_counter()
    print("full-round experiment (exact):", flush=True)
    launches.update(check_full_rounds(dev, rng))
    print(f"phase 7 took {time.perf_counter() - t0:.1f} s", flush=True)

    # 8 - Withdraw on the card
    t0 = time.perf_counter()
    print("Withdraw path:", flush=True)
    wengine, wlanes, wlaunches, wpacked = check_withdraw(rng, card)
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)

    # 9 - the compiled debug routes and the witness vectors
    t0 = time.perf_counter()
    bb_b = production_batch(n_tx, N_LEVELS, max_l1, max_fee, step=3,
                            amount=777)
    print(f"batch B built in {time.perf_counter() - t0:.1f} s: every "
          "account pays the one 3 on, 777 a transfer", flush=True)
    debug_counts = check_debug_paths(engine, inp, bad, out, bb, bb_b,
                                     wengine, wlanes, wpacked, card)
    check_fee_of_one(dev, card)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)

    # 10 - the modules with no kernel of their own
    t0 = time.perf_counter()
    print("modules without a kernel (exact):", flush=True)
    check_new_modules(dev, rng)
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)

    # 11 - the CLI on the card
    t0 = time.perf_counter()
    print("CLI:", flush=True)
    check_cli(card)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)

    # 12 - the tx-lane sharded path
    t0 = time.perf_counter()
    print("sharded path:", flush=True)
    slaunches = check_sharded(engine, packed, bb, bad, card)
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)

    # 13 - the captured engines
    t0 = time.perf_counter()
    print("captured engines:", flush=True)
    check_captured(engine, packed, bb, bb_b, bad, captured, wengine, wlanes,
                   wpacked, rng, card)
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)

    rows = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         graph_launches=captured["counts"][name],
                         withdraw_launches=wlaunches[name],
                         sharded_launches=slaunches[name],
                         debug_graph_launches=debug_counts["debug"][name],
                         withdraw_debug_graph_launches=debug_counts[
                             "withdraw_debug"][name],
                         max_abs_err=r["err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=None))
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
