"""The port's tx-lane sharding in one process on the CPU, against the JAX
package and against the port's single-device path, exactly, at
RollupMain(4, 16, 2, 2) (`torch_compare.rq_batches`: an rq-linked pair on
lanes 1 and 2):

  * the lane-axis tables and the lane dim of every packed key and chain;
  * `rollup_main_lanes` on a slice of lanes, given the rq-link windows and
    the last-lane mask cut from the full width, equals the full-width run
    on those lanes and JAX's `rollup_main_lanes` given the same arguments;
  * a world of one (gloo, `HashStore`): `make_sharded_rollup_main` equals
    `RollupEngine.run_packed`, `check_batch_sharded` equals `check_batch`.

Two processes over gloo are `tests/test_torch_multihost.py`."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from circuits_tpu.engine.witness import pack_rollup_inputs as j_pack
from circuits_tpu.field import fr as j_fr
from circuits_tpu.models import rollup_main as j_rm
from circuits_tpu.parallel import sharding as j_sharding
from circuits_tpu_torch.convert import packed_from_jax
from circuits_tpu_torch.engine.witness import (RollupEngine,
                                               pack_rollup_inputs)
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.models import rollup_main as rm
from circuits_tpu_torch.parallel import (make_sharded_rollup_main,
                                         make_tx_mesh, sharding,
                                         tx_shardings)
from circuits_tpu_torch.r1cs.checker import check_batch, check_batch_sharded

from torch_compare import (RQ_CONFIG, assert_same, one_thread,  # noqa: F401
                           rq_batches)  # one_thread: autouse

N_TX, N_LEVELS, MAX_L1, MAX_FEE = RQ_CONFIG
# (first lane, lanes) cut from the full width: the second half reads lane
# 1's rq data across the cut; the first half holds lane 1, which is not
# the last lane of the batch though it is the last of its slice
SLICES = [(2, 2), (0, 2)]


@pytest.fixture(scope="module")
def batches():
    return rq_batches()


@pytest.fixture(scope="module")
def jpacked(batches):
    """The JAX package's packed numpy of each batch: what both packages
    are fed."""
    return {k: j_pack(bb.get_input(), *RQ_CONFIG)
            for k, bb in batches.items()}


@pytest.fixture(scope="module")
def mesh():
    mesh = make_tx_mesh(1, device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_lane_tables_equal_jax():
    assert sharding.AXIS == j_sharding.AXIS
    assert sharding._LANE_DIM == j_sharding._LANE_DIM
    assert sharding._CHAIN_LANE_DIM == j_sharding._CHAIN_LANE_DIM


def test_every_key_gets_the_jax_lane_dim(mesh, batches, jpacked):
    packed = pack_rollup_inputs(batches["past"].get_input(), *RQ_CONFIG,
                                device="cpu")
    jp = jpacked["past"]
    assert sorted(packed) == sorted(jp)
    dims = tx_shardings(mesh, packed)
    assert dims == {k: j_sharding._LANE_DIM.get(k) for k in jp}
    for k, dim in dims.items():
        if dim is not None:
            assert packed[k].shape[dim] == N_TX, k
    chains = rm.build_chains(packed, N_TX, MAX_FEE)
    jchains = j_rm.build_chains(jp, N_TX, MAX_FEE)
    assert sorted(chains) == sorted(jchains) \
        == sorted(j_sharding._CHAIN_LANE_DIM)
    for k, dim in j_sharding._CHAIN_LANE_DIM.items():
        assert chains[k].shape[dim] == N_TX, k
        assert_same(chains[k], jchains[k], k)


@pytest.fixture(scope="module")
def d1_batch(jpacked):
    """The "past" batch with imOnChain[1] set: lane 1 (an L2 tx) then
    breaks the on-chain chain, which every lane but the globally last one
    checks; lane 2 reads the flag as its previous lane's and stays valid."""
    jp = dict(jpacked["past"])
    jp["im_on_chain"] = np.array(jp["im_on_chain"])
    jp["im_on_chain"][1] = 1
    return jp


@pytest.fixture(scope="module")
def full_width(d1_batch):
    packed = packed_from_jax(d1_batch)
    chains = rm.build_chains(packed, N_TX, MAX_FEE)
    lanes, lane_ok = rm.rollup_main_lanes(packed, chains, N_TX, N_LEVELS,
                                          MAX_FEE)
    assert lane_ok.tolist() == [True, False, True, True]
    return packed, chains, lanes, lane_ok


@jax.jit
def _j_lanes(inp, chains, neighbors, last_mask):
    return j_rm.rollup_main_lanes(inp, chains, 2, N_LEVELS, MAX_FEE,
                                  neighbors=neighbors, last_mask=last_mask)


@pytest.mark.parametrize("lo,n", SLICES)
def test_lane_slice_with_neighbors_equals_full_width_and_jax(
        d1_batch, full_width, lo, n):
    packed, chains, full, full_ok = full_width
    zero1 = fr.zeros((1,))
    neighbors = tuple(w[..., lo:lo + n].contiguous()
                      for k in rm.NEIGHBOR_KEYS
                      for w in rm._neighbors(packed[k], zero1))
    last_mask = torch.arange(lo, lo + n) == N_TX - 1
    cpu = torch.device("cpu")
    inp = sharding.place(
        sharding.lane_slice(packed, sharding._LANE_DIM, lo, n), cpu)
    ch = sharding.place(
        sharding.lane_slice(chains, sharding._CHAIN_LANE_DIM, lo, n), cpu)
    lanes, lane_ok = rm.rollup_main_lanes(inp, ch, n, N_LEVELS, MAX_FEE,
                                          neighbors=neighbors,
                                          last_mask=last_mask)
    assert_same(lane_ok, full_ok[lo:lo + n], "lane_ok")
    assert sorted(lanes) == sorted(full)
    for k in full:
        assert_same(lanes[k], full[k][..., lo:lo + n], k)

    jchains = j_rm.build_chains(d1_batch, N_TX, MAX_FEE)
    jneighbors = tuple(
        np.asarray(w)[..., lo:lo + n] for k in rm.NEIGHBOR_KEYS
        for w in j_rm._neighbors(d1_batch[k], j_fr.zeros((1,))))
    jlanes, jlane_ok = _j_lanes(
        {k: np.asarray(v)[..., lo:lo + n] if j_sharding._LANE_DIM.get(k)
         is not None else v for k, v in d1_batch.items()},
        {k: np.asarray(v)[..., lo:lo + n] for k, v in jchains.items()},
        jneighbors, np.arange(lo, lo + n) == N_TX - 1)
    assert_same(lane_ok, jlane_ok, "lane_ok vs JAX")
    assert_same(lanes, jlanes, "lanes vs JAX")


def test_world_of_one_equals_run_packed(mesh, jpacked):
    packed = packed_from_jax(jpacked["past"])
    out, ok = make_sharded_rollup_main(mesh, *RQ_CONFIG)(packed)
    want, want_ok = RollupEngine(*RQ_CONFIG, device="cpu").run_packed(packed)
    assert bool(ok) and bool(want_ok)
    assert sorted(out) == sorted(want)
    for k in want:
        assert_same(out[k], want[k], k)


def test_world_of_one_check_equals_check_batch(mesh, jpacked):
    packed = packed_from_jax(jpacked["switched"])
    got = check_batch_sharded(mesh, packed, *RQ_CONFIG)
    want = check_batch(packed, *RQ_CONFIG)
    assert got["ok"] is want["ok"] is False
    for mask in ("lane_ok", "fee_ok"):
        assert got[mask].dtype == np.bool_
        assert got[mask].tolist() == want[mask].tolist(), mask
    assert np.flatnonzero(~got["lane_ok"]).tolist() == [1]
