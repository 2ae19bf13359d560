"""The CUDA kernels K1-K6 and AySign2Ax against their plain PyTorch
versions on the card, the suite's batches through `RollupEngine` on `cuda`,
withdrawals through `WithdrawEngine` on `cuda`, `trace` on `cuda` against
`trace` on the CPU, the handoff's file on `cuda` against the CPU's, the
sharded path in a world of one over NCCL against `run_packed`, and the
engines' captured CUDA graphs (`engine/aot.py`), the debug routes' among
them, against their eager route and the builder.
These tests need a CUDA device and skip without one. They import no JAX,
so they also run on a machine that has none:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m gpu tests/test_torch_cuda.py
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from circuits_tpu_torch import kernels
from circuits_tpu_torch.engine.witness import RollupEngine, WithdrawEngine
from circuits_tpu_torch.builder import babyjub
from circuits_tpu_torch.builder.withdraw_utils import hash_inputs_withdraw
from circuits_tpu_torch.field import fr, scalar
from circuits_tpu_torch.ops import (babyjubjub, poseidon, poseidon_rounds,
                                    sha256, smt)
from circuits_tpu_torch.scripts import (eddsa_cases, exp_mxu_inkernel,
                                        rounds_cases, withdraw_cases)

from torch_compare import (RQ_CONFIG, SUITE_CONFIG, assert_same,
                           oracle_outputs, rq_batches, suite_batches)

pytestmark = pytest.mark.gpu

LANES = 300  # not a multiple of the kernels' block sizes
# 1 and 33 lanes are no multiple of a thread group's lanes a warp (K1: 8 or
# 4, K2: 4); 4096 is the main path's SMT call at RollupMain(2048, ...)
LANE_COUNTS = [1, 33, 1000, 4096]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _field(rng, shape):
    """Canonical field elements (16, *shape) from numpy's generator."""
    vals = rng.integers(0, 2**63, size=shape + (4,), dtype=np.uint64)
    ints = [sum(int(w) << (64 * i) for i, w in enumerate(row)) % scalar.P
            for row in vals.reshape(-1, 4)]
    return fr.pack(np.array(ints, dtype=object).reshape(shape).tolist())


@pytest.mark.parametrize("lanes", LANE_COUNTS)
@pytest.mark.parametrize("t", [3, 4, 5, 6, 7])
def test_poseidon_kernel_matches_plain(cuda, t, lanes):
    state = _field(np.random.default_rng(t), (t, lanes))
    state[:, :, 0] = fr.pack([0, scalar.P - 1, 1, 0, scalar.P - 1, 2, 3][:t])
    state = state.to(cuda)
    got = poseidon.permute_mont(state)
    assert_same(got, poseidon.permute_mont_plain(state, schedule="sparse"))
    assert_same(got, poseidon.permute_mont_plain(state, schedule="dense"))


@pytest.mark.parametrize("lanes", LANE_COUNTS)
def test_smt_kernel_matches_plain(cuda, lanes):
    """Random masks, every combination of the five (also `top` with `bot`,
    which the state machine never sets together), and levels with no mask
    at all."""
    rng = np.random.default_rng(3)
    n = 9
    sib = _field(rng, (n, lanes)).permute(1, 0, 2).contiguous()
    sib[:, :, ::3] = 0  # empty subtrees below some lanes
    bits = torch.from_numpy(rng.integers(0, 2, (n, lanes)))
    masks = torch.from_numpy(rng.integers(0, 2, (n, 5, lanes)))
    masks[:3] = 0
    masks[5, :, ::2] = 0
    leaves = [_field(rng, (lanes,)) for _ in range(3)]
    args = [x.to(cuda).contiguous() for x in (sib, bits, masks, *leaves)]
    assert_same(smt.processor_chain(*args),
                smt.processor_chain_plain(*args))


def test_eddsa_kernel_matches_plain(cuda):
    rng = np.random.default_rng(8)
    rows = []
    for i in range(8):
        prv = rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()
        pub = babyjub.prv2pub(prv)
        msg = int(rng.integers(0, 2**62))
        sig = babyjub.sign_poseidon(prv, msg)
        s = sig["S"] + [0, 1, 1 << 253, 1 << 252][i % 4]
        rows.append((pub[0], pub[1], s, sig["R8"][0], sig["R8"][1], msg))
    cols = [fr.pack([r[k] for r in rows]).to(cuda) for k in range(6)]
    ax, ay, s, r8x, r8y, msg = cols
    hm = poseidon.poseidon([r8x, r8y, ax, ay, msg]).contiguous()
    m = [fr.to_mont(c).contiguous() for c in (ax, ay, r8x, r8y)]
    args = (m[0], m[1], s, m[2], m[3], hm)
    got = babyjubjub.eddsa_ok_mont(*args)
    assert_same(got, babyjubjub.eddsa_ok_mont_plain(*args))
    assert got.tolist() == [True, False, True, False] * 2


@pytest.mark.parametrize("lanes", [1, 5, 33])
def test_eddsa_kernel_edge_lanes(cuda, lanes):
    """The edge lanes (A off the curve, A or R8 the identity, hm = 0, S = 0,
    every hm digit below the top one 15, each with a wrong twin), repeated
    up to `lanes`: fewer lanes than a warp holds, and a ragged last warp."""
    edge = eddsa_cases.edge_lanes(random.Random(lanes))
    edge = [edge[i % len(edge)] for i in range(lanes)]
    args = eddsa_cases.kernel_args([row for _, row, _ in edge], cuda)
    got = babyjubjub.eddsa_ok_mont(*args)
    assert_same(got, babyjubjub.eddsa_ok_mont_plain(*args))
    for (name, _, want), ok in zip(edge, got.tolist()):
        assert want is None or ok == want, name


@pytest.mark.parametrize("lanes", [1, 3, 2049])
def test_ay_sign_kernel_matches_plain(cuda, lanes):
    """AySign2Ax's kernel against its plain version, limb for limb over ax
    and ok, and against the host's scalar version: a point's y, y = 0, 1 and
    p - 1, y values whose x^2 is a non-residue, each with both signs, then
    random field elements; one lane, a part of a warp, a ragged last block
    past the main path's 2,048. No lane has den = A - D y^2 = 0: A / D is a
    non-residue mod p, so no y gives y^2 = A / D."""
    from circuits_tpu_torch.r1cs import witness_check as wc

    assert eddsa_cases.den_zero_y() is None
    ays, signs = eddsa_cases.ay_sign_lanes(random.Random(lanes), lanes)
    ay = fr.pack(ays).to(cuda)
    sign = torch.tensor(signs, dtype=torch.bool, device=cuda)
    kernels.reset_launches()
    got = babyjubjub.ay_sign_to_ax(ay, sign)
    assert kernels.launches["ay_sign_to_ax"] == 1
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool
    assert_same(got, babyjubjub.ay_sign_to_ax_plain(ay, sign))
    host = [wc._ay_sign_to_ax(y, g) for y, g in zip(ays[:64], signs)]
    assert [(int(x), bool(k)) for x, k in zip(
        fr.unpack_np(got[0].cpu())[:64], got[1].tolist())] == host


# (lanes, blocks): both routes of the kernel ("edge" is the last lane count
# of the narrow route as the library reports it, "past" the first of the
# wide one), several narrow lanes, chains that end at, past and inside a stage
@pytest.mark.parametrize("lanes,nblocks", [
    (LANES, 1), (LANES, 3), (4, 5), ("edge", 2), ("past", 2), (1, 32),
    (1, 33), (2, 97), (4096, 2)])
def test_sha256_kernel_matches_plain_and_hashlib(cuda, lanes, nblocks):
    if isinstance(lanes, str):
        lanes = sha256.narrow_route_lanes(cuda) + (lanes == "past")
    rng = np.random.default_rng(nblocks)
    msgs = [rng.integers(0, 256, 64 * nblocks - 9, dtype=np.uint8).tobytes()
            for _ in range(lanes)]
    words = torch.tensor(
        [[int.from_bytes(m + b"\x80" + (8 * len(m)).to_bytes(8, "big"))
          >> (32 * (16 * nblocks - 1 - w)) & 0xFFFFFFFF
          for m in msgs] for w in range(16 * nblocks)],
        dtype=torch.int64, device=cuda)
    got = sha256.sha256_chain(words, nblocks)
    assert_same(got, sha256.sha256_chain_plain(words, nblocks))
    for lane in {0, lanes // 2, lanes - 1}:
        digest = b"".join(int(v).to_bytes(4, "big")
                          for v in got[:, lane].tolist())
        assert digest == hashlib.sha256(msgs[lane]).digest()


def test_engine_on_cuda_matches_builder_through_the_kernels(cuda):
    """Every suite batch through one engine (the first op by op, the second
    captured, the rest replayed), each through every kernel of the main
    path: the wrappers' launches, and for a replay the graph's kernel
    nodes."""
    engine = RollupEngine(*SUITE_CONFIG, device=cuda)
    for name, bb in suite_batches().items():
        replays = engine.call.replays
        kernels.reset_launches()
        out, ok = engine.run(bb.get_input())
        ran = {k: n + (engine.call.replays - replays) * engine.call.counts[k]
               for k, n in kernels.launches.items()}
        assert ok, name
        want = oracle_outputs(bb)
        assert {k: out[k] for k in want} == want, name
        assert all(ran[k] > 0 for k in kernels.MAIN_PATH), (name, ran)
    assert engine.call.replays == len(suite_batches()) - 1


def test_full_round_kernels_match_plain_each_other_and_mirror(cuda):
    """K5 and K6 at LANES x 3 rounds, at K6's geometry edges (1, 33 and 257
    lanes: 32 lanes a warp, 256 a block) x 0, 1 and 3 rounds, and on the
    edge lanes of scripts/rounds_cases.py: each against its plain version,
    the two against each other and the bigint mirror."""
    cases = [(exp_mxu_inkernel.random_state(lanes), rounds)
             for lanes, rounds in [(LANES, 3)] + [
                 (n, r) for n in (1, 33, 257) for r in (0, 1, 3)]]
    cases += [(rounds_cases.edge_lanes(), r) for r in (1, 3)]
    for (state, vals), rounds in cases:
        x = state.to(cuda)
        lanes = x.shape[-1]
        vpu = poseidon_rounds.full_rounds_vpu(x, rounds)
        mxu = poseidon_rounds.full_rounds_mxu(x, rounds)
        assert_same(vpu, poseidon_rounds.full_rounds_vpu_plain(x, rounds))
        assert_same(mxu, poseidon_rounds.full_rounds_mxu_plain(x, rounds))
        assert_same(vpu, mxu)
        got = fr.unpack_np(vpu)
        for lane in sorted({0, lanes // 2, lanes - 1}):
            want = poseidon_rounds.full_rounds_py(
                [vals[e][lane] for e in range(3)], rounds)
            assert [int(got[e, lane]) for e in range(3)] == want, \
                (lanes, rounds, lane)


@pytest.mark.parametrize("lanes", [1, "past"])
def test_withdraw_engine_on_cuda_matches_builder(cuda, lanes):
    """One lane (K4's narrow route) and one lane more than the narrow route
    serves (its wide route): every valid lane accepted with the builder's
    hash, each kind of tampered lane refused, through K1 and K4 alone."""
    n_levels = 16
    if lanes == "past":
        lanes = sha256.narrow_route_lanes(cuda) + 1
    rng = random.Random(lanes)
    batch = withdraw_cases.exit_tree_batch(rng, max(lanes, 2), n_levels)
    batch = batch[:lanes]
    kinds = {}
    if lanes > 1:
        for j, lane in enumerate(rng.sample(range(lanes), 8)):
            kinds[lane] = withdraw_cases.TAMPERS[j % 4]
            batch[lane] = withdraw_cases.tamper(batch[lane], kinds[lane],
                                                n_levels)
    engine = WithdrawEngine(n_levels, device=cuda)
    kernels.reset_launches()
    hashes, ok = engine.run(batch)  # the width's first batch: op by op
    assert isinstance(ok, np.ndarray) and ok.dtype == np.bool_
    assert np.flatnonzero(~ok).tolist() == sorted(kinds)
    assert hashes == [hash_inputs_withdraw(d) for d in batch]
    assert kernels.launches["poseidon_permute"] == 3 + n_levels + 1
    assert kernels.launches["sha256_chain"] == 1
    assert kernels.launches["smt_chain"] == 0
    assert kernels.launches["eddsa_check"] == 0


def test_trace_on_cuda_equals_trace_on_cpu(cuda):
    inp = suite_batches()["l2"].get_input()
    got = RollupEngine(*SUITE_CONFIG, device=cuda).trace(inp)
    want = RollupEngine(*SUITE_CONFIG, device="cpu").trace(inp)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert got["lane_ok"] == [True] * SUITE_CONFIG[0]


def test_handoff_on_cuda_writes_the_cpu_bytes_from_one_pinned_buffer(
        cuda, tmp_path, monkeypatch):
    """At the suite's shape the handoff on `cuda` (op by op, then captured)
    writes the bytes and returns the outputs of the handoff on the CPU; its
    two handoffs copy into one page-locked buffer of the vector's size, made
    once."""
    from circuits_tpu_torch.engine import witness, witness_vector

    inp = suite_batches()["l2"].get_input()
    want = witness_vector.handoff(RollupEngine(*SUITE_CONFIG, device="cpu"),
                                  inp, tmp_path / "cpu.wtns")
    assert want[1] is True
    nbytes = 32 * len(witness_vector.signal_names(*SUITE_CONFIG))
    key = (cuda.index, nbytes)
    witness._STAGING.pop(key, None)
    made = []

    class Counted(witness._Staging):
        def __init__(self, n):
            made.append(n)
            super().__init__(n)

    monkeypatch.setattr(witness, "_Staging", Counted)
    engine, stages = RollupEngine(*SUITE_CONFIG, device=cuda), []
    for k in range(2):
        path = tmp_path / f"cuda{k}.wtns"
        assert witness_vector.handoff(engine, inp, path) == want
        assert path.read_bytes() == (tmp_path / "cpu.wtns").read_bytes()
        stages.append(witness._STAGING[key])
    assert made.count(nbytes) == 1
    assert stages[0] is stages[1] and stages[0].host.is_pinned()


def test_world_of_one_over_nccl_equals_run_packed(cuda):
    """The sharded path in a world of one (NCCL, in process) on a batch
    whose rq-linked pair sits on lanes 1 and 2: every output equal to
    `run_packed`'s, the hash to the builder's, through every kernel of the
    main path."""
    import torch.distributed as dist
    from circuits_tpu_torch.engine.witness import pack_rollup_inputs
    from circuits_tpu_torch.parallel import (make_sharded_rollup_main,
                                             make_tx_mesh)

    bb = rq_batches()["past"]
    packed = pack_rollup_inputs(bb.get_input(), *RQ_CONFIG, device=cuda)
    mesh = make_tx_mesh(1, device=cuda)
    try:
        assert dist.get_backend() == "nccl"
        kernels.reset_launches()
        out, ok = make_sharded_rollup_main(mesh, *RQ_CONFIG)(packed)
        launches = dict(kernels.launches)
    finally:
        dist.destroy_process_group()
    want, want_ok = RollupEngine(*RQ_CONFIG, device=cuda).run_packed(packed)
    assert bool(ok) and bool(want_ok)
    assert sorted(out) == sorted(want)
    for k in want:
        assert_same(out[k], want[k], k)
    assert fr.unpack_int(out["hash_global_inputs"]) == bb.get_hash_inputs()
    assert all(launches[k] > 0 for k in kernels.MAIN_PATH), launches


def _no_wrapper(*args, **kwargs):
    raise AssertionError("a replay called a Python kernel wrapper")


def test_captured_rollup_main_equals_eager_and_builder(cuda, monkeypatch):
    """Batches A, B, A and a tampered A through one engine: A op by op, B
    captured and replayed, then replays of the graph, which call no Python
    kernel wrapper and add nothing to `kernels.launches`; the graph's
    kernel nodes, read from the graph, are the launches of the eager run.
    Each output limb-equal to the eager route's, A's and B's to the
    builder's, the tampered one refused. (The CPU tests hold the same
    bookkeeping against the JAX package, which the card's machine does not
    have.)"""
    from circuits_tpu_torch.engine import witness

    engine = RollupEngine(*SUITE_CONFIG, device=cuda)
    bbs = suite_batches()
    bad = dict(bbs["l2"].get_input())  # get_input() keeps its dict
    bad["s"] = list(bad["s"])
    bad["s"][0] = (bad["s"][0] + 1) % scalar.P
    inputs = [bbs["l2"].get_input(), bbs["deposit"].get_input(),
              bbs["l2"].get_input(), bad]
    packs = [engine.pack(inp) for inp in inputs]
    kernels.reset_launches()
    eager = [engine.run_packed_eager(p) for p in packs]
    eager_launches = {k: n // 4 for k, n in kernels.launches.items()}
    graph = engine.call
    kernels.reset_launches()
    outs = [engine.run_packed(p) for p in packs[:2]]
    # A ran op by op; B's recording was taken back out, its replay adds none
    assert kernels.launches == eager_launches
    assert graph.counts == eager_launches and graph.nodes > 1000
    assert all(graph.counts[k] > 0 for k in kernels.MAIN_PATH), graph.counts
    # AySign2Ax is one node, where its plain version was some 180,000
    assert graph.counts["ay_sign_to_ax"] == 1 and graph.nodes < 10_000, \
        (graph.counts, graph.nodes)
    assert engine.compile() is graph and graph.replays == 1
    kernels.reset_launches()
    for mod, name in ((poseidon, "permute_mont"), (smt, "processor_chain"),
                      (babyjubjub, "eddsa_ok_mont"),
                      (babyjubjub, "ay_sign_to_ax"),
                      (sha256, "sha256_chain"), (witness, "rollup_main")):
        monkeypatch.setattr(mod, name, _no_wrapper)
    outs += [engine.run_packed(p) for p in packs[2:]]
    monkeypatch.undo()
    assert graph.replays == 3
    assert not any(kernels.launches.values()), kernels.launches
    for (out, ok), (want, want_ok) in zip(outs, eager):
        assert bool(ok) == bool(want_ok)
        assert sorted(out) == sorted(want)
        for k in want:
            assert_same(out[k], want[k], k)
    for (out, ok), name in zip(outs[:3], ("l2", "deposit", "l2")):
        assert bool(ok), name
        want = oracle_outputs(bbs[name])
        got = engine.unpack_outputs(out)
        assert {k: got[k] for k in want} == want, name
    assert not bool(outs[3][1])
    assert outs[0][0]["hash_global_inputs"].data_ptr() != \
        outs[2][0]["hash_global_inputs"].data_ptr()
    assert_same(outs[0][0], outs[2][0])


def test_captured_call_refuses_other_shapes(cuda):
    engine = RollupEngine(*SUITE_CONFIG, device=cuda)
    packed = engine.pack(suite_batches()["l2"].get_input())
    engine.compile()
    with pytest.raises(ValueError, match="captured for"):
        engine.run_packed(dict(packed, s=packed["s"][:, :2]))
    with pytest.raises(ValueError, match="captured for"):
        engine.run_packed(dict(packed, s=packed["s"].cpu()))


@pytest.mark.parametrize("lanes", [1, 33])
def test_captured_withdraw_equals_eager_and_builder(cuda, lanes):
    """Withdraw's graph at 1 and 33 lanes (one graph a width, captured
    ahead): hashes and verdicts equal the eager route's and the builder's,
    exactly the tampered lanes refused, A/B/A replays exact; the graph's
    kernel nodes are K1's and K4's launches of one eager batch."""
    n_levels = 16
    rng = random.Random(100 + lanes)
    good = withdraw_cases.exit_tree_batch(rng, max(lanes, 2), n_levels)
    good = good[:lanes]
    bad = list(good)
    tampered = sorted(rng.sample(range(lanes), min(lanes, 4)))
    for j, lane in enumerate(tampered):
        bad[lane] = withdraw_cases.tamper(good[lane], withdraw_cases.TAMPERS[j],
                                          n_levels)
    engine = WithdrawEngine(n_levels, device=cuda)
    graph = engine.compile(lanes)
    assert "warmup" in graph.seconds and graph.replays == 0
    kernels.reset_launches()
    runs = [engine.run(b) for b in (good, bad, good)]
    assert not any(kernels.launches.values()) and graph.replays == 3
    assert graph.counts == {**dict.fromkeys(kernels.launches, 0),
                            "poseidon_permute": 3 + n_levels + 1,
                            "sha256_chain": 1}
    for (hashes, ok), batch in zip(runs, (good, bad, good)):
        assert hashes == [hash_inputs_withdraw(d) for d in batch]
        h, k = engine.run_packed_eager(engine.pack(batch))
        assert hashes == [int(v) for v in fr.unpack_np(h)]
        assert ok.tolist() == fr.to_numpy(k).tolist()
    assert runs[0][1].all() and runs[2][1].all()
    assert np.flatnonzero(~runs[1][1]).tolist() == tampered
    assert runs[0][0] == runs[2][0]


def test_withdraw_widths_share_one_graph_pool(cuda):
    """Two widths of one engine capture into one memory pool, and the
    narrower graph still replays right after the wider one was captured.
    The engine is made on "cuda" with no index, as a user makes it: its
    tensors then lie on cuda:0, which its captured calls must accept."""
    n_levels = 16
    lanes = withdraw_cases.exit_tree_batch(random.Random(5), 33, n_levels)
    engine = WithdrawEngine(n_levels, device="cuda")
    narrow, wide = engine.compile(1), engine.compile(33)
    assert narrow.pool is wide.pool is not None
    assert narrow.graph.pool() == wide.graph.pool()
    for batch in (lanes, lanes[:1], lanes, lanes[:1]):
        hashes, ok = engine.run(batch)
        assert ok.all() and hashes == [hash_inputs_withdraw(d) for d in batch]
    assert narrow.replays == wide.replays == 2


def test_captured_debug_routes_equal_eager_and_share_one_pool(cuda):
    """The engine's one debug route, `debug_call`, on batches A, B, A and a
    tampered A: the first op by op, B captured, the rest replayed; its
    kernel nodes are the first call's wrapper launches and every output
    equals the eager route's. The engine is the one `check_batch` keeps for
    the circuit and card, and holds two CapturedCalls: `check_batch`
    (naming the tampered lane), `_full_debug`, `trace` and `get_signal` are
    one replay of `debug_call` each. Its two graphs lie in one pool and
    replay in turns, each exact."""
    from circuits_tpu_torch.engine.aot import CapturedCall
    from circuits_tpu_torch.r1cs import checker

    checker._ENGINES.pop((SUITE_CONFIG, cuda), None)  # a fresh engine
    engine = checker.engine_for(SUITE_CONFIG, cuda)
    # "cuda" without an index is the same card, so the same engine
    assert checker.engine_for(SUITE_CONFIG, "cuda") is engine
    assert [v for v in vars(engine).values()
            if isinstance(v, CapturedCall)] == [engine.call, engine.debug_call]
    bbs = suite_batches()
    a, b = bbs["l2"].get_input(), bbs["deposit"].get_input()
    bad = dict(a)
    bad["s"] = list(a["s"])
    bad["s"][0] = (bad["s"][0] + 1) % scalar.P
    pa, pb, pbad = (engine.pack(x) for x in (a, b, bad))
    call = engine.debug_call
    kernels.reset_launches()
    first = call(pa)
    launches = dict(kernels.launches)
    kernels.reset_launches()
    outs = [call(p) for p in (pb, pa, pbad)]
    assert not any(kernels.launches.values()), kernels.launches
    assert call.counts == launches and call.replays == 3
    assert call.counts["ay_sign_to_ax"] == 1, call.counts
    for out, p in zip([first] + outs, (pa, pb, pa, pbad)):
        assert_same(out, engine.debug_eager(p))
    kernels.reset_launches()
    res = checker.check_batch(pbad, *SUITE_CONFIG)
    assert np.flatnonzero(~res["lane_ok"]).tolist() == [0]
    assert res["fee_ok"].tolist() == [True] * SUITE_CONFIG[3]
    lanes, lane_ok, dout, ok = engine._full_debug(a)
    assert bool(ok) and engine.unpack_outputs(dout)["hash_global_inputs"] \
        == bbs["l2"].get_hash_inputs()
    tr = engine.trace(a)
    assert tr["lane_ok"] == [True] * SUITE_CONFIG[0]
    assert engine.get_signal(a, "states.key1[0]") == tr["states.key1"][0]
    assert call.replays == 7 and not any(kernels.launches.values())
    main = engine.run_packed(pa)  # op by op: the main call's first batch
    engine.compile()
    refs = {"main": main, "debug": outs[1]}
    runs = {"main": lambda: engine.run_packed(pa),
            "debug": lambda: call(pa)}
    for name in ("main", "debug", "main"):
        assert_same(runs[name](), refs[name], name)
    assert engine.call.graph.pool() == call.graph.pool()


def test_captured_withdraw_debug_equals_eager(cuda):
    n_levels = 16
    rng = random.Random(33)
    good = withdraw_cases.exit_tree_batch(rng, 33, n_levels)
    bad = list(good)
    bad[4] = withdraw_cases.tamper(good[4], "balance", n_levels)
    engine = WithdrawEngine(n_levels, device=cuda)
    kernels.reset_launches()
    runs = [engine.run_debug(good)]
    launches = dict(kernels.launches)
    kernels.reset_launches()
    runs += [engine.run_debug(x) for x in (bad, good)]
    call = engine.debug_call_for(33)
    assert not any(kernels.launches.values()) and call.replays == 2
    assert call.counts == launches and call.pool is engine._pool
    for (h, ok, dbg), batch in zip(runs, (good, bad, good)):
        assert h == [hash_inputs_withdraw(d) for d in batch]
        eh, eok, edbg = engine.run_packed_eager(engine.pack(batch),
                                                debug=True)
        assert ok.tolist() == fr.to_numpy(eok).tolist()
        assert_same(dbg, edbg)
    assert np.flatnonzero(~runs[1][1]).tolist() == [4]


def test_captured_call_clones_aliased_leaves_on_cuda(cuda):
    """On the card, one tensor twice, a static input passed through and
    leaves that are no tensors: every returned tensor is a clone of its
    own, right after later batches were loaded and replayed."""
    from circuits_tpu_torch.engine import aot

    def fn(d):
        y = d["x"] * 2
        return {"same": y, "again": y, "input": d["x"], "n": 3,
                "none": None}

    call = aot.CapturedCall(fn, {"x": ((16, 3), torch.int64)}, cuda)
    outs = [(i, call({"x": torch.full((16, 3), i, device=cuda)}))
            for i in (1, 2, 1, 3)]
    # on the card the capture's call replays too
    assert call.replays == 3 and call.graph is not None
    seen = set()
    for i, out in outs:
        assert (out["n"], out["none"]) == (3, None)
        assert torch.equal(out["same"], torch.full((16, 3), 2 * i,
                                                   device=cuda))
        assert torch.equal(out["again"], out["same"])
        assert torch.equal(out["input"], torch.full((16, 3), i, device=cuda))
        ptrs = {out[k].data_ptr() for k in ("same", "again", "input")}
        assert len(ptrs) == 3 and not ptrs & seen
        assert call.inputs["x"].data_ptr() not in ptrs
        seen |= ptrs
