"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is then non-zero):
 1. print the card (nvidia-smi name, power limit) and the torch/CUDA
    versions; refuse to run without CUDA;
 2. build the kernels from circuits_tpu_torch/csrc with nvcc (sm_90a);
 3. check each kernel against its plain PyTorch version on the card,
    exactly, at the main path's per-lane shapes and 1000 lanes (not a
    multiple of the block size): K1 Poseidon t = 3..7, K2 SMT chain n = 33
    on INSERT / UPDATE / DELETE / NOP lanes, K3 EdDSA on valid, tampered
    and s >= 2^253 lanes, K4 SHA-256 at 1, 3 and 822 blocks (also against
    hashlib); then again at the lane counts of the main path's calls at
    RollupMain(2048, 32, 256, 64), where both versions are timed;
 4. build a RollupMain(2048, 32, 256, 64) batch with the shared builder
    (2048 accounts by L1 deposits, 2048 signed L2 transfers, one fee
    token), run `RollupEngine(...).run` on the card, hold the hash, roots
    and newLastIdx exactly against the builder, and require that every
    kernel was launched during that run;
 5. tamper one lane's signature scalar and require ok == False;
 6. time the host build, pack, first call and steady state.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from circuits_tpu_torch import kernels  # noqa: E402
from circuits_tpu_torch.engine.witness import RollupEngine  # noqa: E402
from circuits_tpu_torch.field import fr  # noqa: E402
from circuits_tpu_torch.host import (SMT, HermezAccount, RollupDB,  # noqa: E402
                                     babyjub, float40, poseidon_constants,
                                     scalar)
from circuits_tpu_torch.ops import babyjubjub, poseidon, sha256, smt  # noqa: E402

LANES = 1000
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
}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return res.stdout.strip().splitlines()[0]


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


def compare(name, note, kernel_fn, plain_fn, reps, timed=True):
    """Hold the kernel's result against its plain version's, exactly, and
    time both when `timed`; the last timed shape of a kernel is the one
    reported in the kernels line. Returns the kernel's result."""
    got = kernel_fn()  # also the warm-up calls of both
    err = max_err(got, plain_fn())
    r = results.setdefault(name, dict(err=0, ms=None, plain_ms=None))
    r["err"] = max(r["err"], err)
    line = f"  {name:17s} {note:36s} max_abs_err={err}"
    if timed:
        r["ms"], r["plain_ms"] = kernel_ms(kernel_fn, reps), plain_ms(plain_fn)
        line += f" kernel={r['ms']:.4f} ms plain={r['plain_ms']:.1f} ms"
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


def check_poseidon(dev, rng):
    for t, lanes in [(t, LANES) for t in range(3, 8)] + POSEIDON_MAIN_PATH:
        vals = [[rng.randrange(scalar.P) for _ in range(lanes)]
                for _ in range(t)]
        state = fr.pack(vals, dev).contiguous()  # (16, t, lanes), Mont.
        compare("poseidon_permute", f"t={t} B={lanes}",
                lambda: poseidon.permute_mont(state),
                lambda: poseidon.permute_mont_plain(state), 10,
                timed=lanes != LANES)
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


def check_smt(dev, rng):
    ops, n = _smt_lanes(rng, N_LEVELS)
    sib = fr.pack([o["siblings"] + [0] * (n - len(o["siblings"]))
                   for o in ops], dev).permute(2, 0, 1).contiguous()

    def col(key):
        return fr.pack([o[key] for o in ops], dev)

    def flag(fn):
        return torch.tensor([fn(o) for o in ops], device=dev)

    args = dict(siblings=sib, old_key=col("old_key"),
                old_value=col("old_value"),
                is_old0=flag(lambda o: int(o["is_old0"])),
                new_key=col("new_key"), new_value=col("new_value"),
                fnc0=flag(lambda o: o["fnc"][0]),
                fnc1=flag(lambda o: o["fnc"][1]))
    cargs = smt.chain_args(**args)
    compare("smt_chain", f"n={n} B={LANES} ins/upd/del/nop",
            lambda: smt.processor_chain(*cargs),
            lambda: smt.processor_chain_plain(*cargs), 5, timed=False)
    new_root, ok = smt.processor(col("old_root"), **args)
    assert bool(ok.all()), "SMT processor rejected a valid host proof"
    want_roots = [o["new_root"] for o in ops]
    assert [int(v) for v in fr.unpack_np(new_root)] == want_roots
    # the main path's call: both RollupTx processors of 2048 lanes
    big = [tile(x, 4096) for x in cargs]
    compare("smt_chain", f"n={n} B=4096 (lanes tiled)",
            lambda: smt.processor_chain(*big),
            lambda: smt.processor_chain_plain(*big), 5)


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
    # the main path's call: one signature check per tx lane
    big = [tile(x, 2048) for x in cargs]
    compare("eddsa_check", "B=2048 (lanes tiled)",
            lambda: babyjubjub.eddsa_ok_mont(*big),
            lambda: babyjubjub.eddsa_ok_mont_plain(*big), 5)


def _sha_words(msg: bytes, dev):
    """hashlib-style padding -> (nblocks * 16, 1) int64 words."""
    n = len(msg)
    padded = msg + b"\x80" + b"\x00" * ((55 - n) % 64) + (8 * n).to_bytes(
        8, "big")
    words = [int.from_bytes(padded[i:i + 4], "big")
             for i in range(0, len(padded), 4)]
    return torch.tensor(words, dtype=torch.int64, device=dev)[:, None]


def check_sha(dev, rng):
    # ragged lanes: 1 block x 1000 lanes
    words = torch.cat([_sha_words(rng.randbytes(40), dev)
                       for _ in range(LANES)], dim=1).contiguous()
    compare("sha256_chain", f"nblocks=1 B={LANES}",
            lambda: sha256.sha256_chain(words, 1),
            lambda: sha256.sha256_chain_plain(words, 1), 5, timed=False)
    # single chains, the last at the main path's HashInputs preimage
    for nblocks in (1, 3, 822):
        msg = rng.randbytes(64 * nblocks - 9)
        words = _sha_words(msg, dev)
        got = compare("sha256_chain", f"nblocks={nblocks} B=1",
                      lambda: sha256.sha256_chain(words, nblocks),
                      lambda: sha256.sha256_chain_plain(words, nblocks), 5,
                      timed=nblocks == 822)
        digest = b"".join(int(v).to_bytes(4, "big")
                          for v in got[:, 0].cpu().tolist())
        assert digest == hashlib.sha256(msg).digest(), "SHA-256 != hashlib"


def production_batch(n_tx, n_levels, max_l1, max_fee):
    """The scripts/exp_production.py recipe: populate n_tx accounts with
    L1 deposits, then one batch of n_tx signed L2 transfers (a ring) with
    one fee token."""
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
        tx = dict(fromIdx=256 + i, toIdx=256 + ((i + 1) % n_tx), tokenID=1,
                  amount=1000, userFee=126, nonce=0, onChain=0)
        accounts[i].sign_tx(tx)
        bb.add_tx(tx)
    bb.build()
    return bb


def main() -> None:
    # 1 - the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
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

    # 3 - each kernel against its plain version
    print("kernel checks (exact):", flush=True)
    check_poseidon(dev, rng)
    check_smt(dev, rng)
    check_eddsa(dev, rng)
    check_sha(dev, rng)

    # 4 - the production batch through the engine
    n_tx, max_l1, max_fee = 2048, 256, 64
    t0 = time.perf_counter()
    bb = production_batch(n_tx, N_LEVELS, max_l1, max_fee)
    inp = bb.get_input()
    t_host = time.perf_counter() - t0
    engine = RollupEngine(n_tx, N_LEVELS, max_l1, max_fee, device=dev)
    t0 = time.perf_counter()
    packed = engine.pack(inp)
    sync()
    t_pack = time.perf_counter() - t0

    kernels.reset_launches()
    t0 = time.perf_counter()
    out, ok = engine.run(inp)
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
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched by the main path"

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

    rows = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=r["err"], ms=r["ms"],
                         plain_ms=r["plain_ms"]))
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
