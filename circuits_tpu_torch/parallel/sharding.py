"""Tx-lane sharding of RollupMain over a 1-D mesh of torch.distributed ranks.

Port of `circuits_tpu/parallel/sharding.py`, where `shard_map` runs one
program a device and XLA's collectives cross the mesh. Here each rank of a
process group is one device, holds one contiguous slice of the tx lanes,
and runs the single-device lane phases on it (decode, EdDSA, balance
update, both SMT processors) with no communication: the im chains arrive as
per-lane inputs, the reference's own parallelisation contract
(src/rollup-main.circom:93-99). The cross-lane reads are explicit
collectives of the rank's group:

  * the rq-link windows (+-3/+-4 lanes): an all-gather of the three small
    per-tx arrays, each rank then cuts its own windows;
  * the verdict: an all-reduce (sum) of the ranks' failure counts;
  * the global tail (fee transactions + the SHA-256 of the public inputs)
    reads every lane's data-availability bits: an all-gather of the lane
    outputs, then the same computation on every rank.

The im chains of length T-1 become per-lane arrays of length T before the
lanes are cut (`models.rollup_main.build_chains`), so every cut array has
the whole lane axis. The mesh is torch's `DeviceMesh` with its one dim
named "tx"; each rank's device is its current CUDA device, or the CPU.
`make_sharded_rollup_main(mesh, ...)` returns the run; nTx must divide
over the mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..engine.witness import resolve_device
from ..field import fr
from ..models import rollup_main as rm

AXIS = "tx"

# input key -> which dim is the tx-lane dim (None = replicated)
_LANE_DIM = {
    # per-tx field arrays (16, T)
    "tx_compressed_data": 1, "amount_f": 1, "tx_compressed_data_v2": 1,
    "from_idx": 1, "aux_from_idx": 1, "to_idx": 1, "aux_to_idx": 1,
    "to_bjj_ay": 1, "to_eth_addr": 1, "max_num_batch": 1,
    "rq_tx_compressed_data_v2": 1, "rq_to_eth_addr": 1, "rq_to_bjj_ay": 1,
    "s": 1, "r8x": 1, "r8y": 1, "load_amount_f": 1, "from_eth_addr": 1,
    "token_id1": 1, "nonce1": 1, "balance1": 1, "ay1": 1, "eth_addr1": 1,
    "old_key1": 1, "old_value1": 1,
    "token_id2": 1, "nonce2": 1, "balance2": 1, "ay2": 1, "eth_addr2": 1,
    "old_key2": 1, "old_value2": 1,
    # per-tx flags (T,)
    "on_chain": 0, "new_account": 0, "new_exit": 0, "is_old0_1": 0,
    "is_old0_2": 0, "sign1": 0, "sign2": 0, "rq_offset": 0,
    # bits (256, T)
    "from_bjj_compressed": 1,
    # siblings (L+1, 16, T)
    "siblings1": 2, "siblings2": 2,
    # scalars / fee-slot arrays / im chains: replicated (im chains are
    # consumed through build_chains before the lanes are cut, see
    # make_sharded_rollup_main)
}

# chain arrays produced by build_chains: lane dim index
_CHAIN_LANE_DIM = {
    "prev_on_chain": 0, "im_oc_next": 0, "in_idx": 1, "old_state_root": 1,
    "old_exit_root": 1, "acc_fee_in": 2, "expected_out_idx": 1,
    "expected_state_root": 1, "expected_exit_root": 1,
    "expected_acc_fee": 2,
}

# the lane outputs the global tail reads, and their lane dims
_TAIL_LANE_DIM = {
    "l1_tx_full_data": 1, "l1l2_tx_data": 1, "is_amount_nullified": 0,
    "out_idx": 1, "new_exit_root": 1, "acc_fee_out": 2,
}


def make_tx_mesh(n_devices: int | None = None,
                 device="cuda") -> DeviceMesh:
    """The 1-D "tx" mesh over every rank of the default process group, one
    device a rank (the rank's current CUDA device, or the CPU).

    With no process group and `n_devices` in (None, 1) it first makes a
    world of one in this process (a `HashStore`, rank 0; NCCL for a CUDA
    device, gloo for the CPU), so that the sharded path runs its
    collectives at every world size. A larger mesh needs a group of as
    many ranks (`parallel.distributed.initialize` in each process)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"a mesh of {n_devices} devices needs a process group of as "
                "many ranks: call parallel.distributed.initialize in each")
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{world} ranks")
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(AXIS,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def tx_shardings(mesh: DeviceMesh, inp: dict) -> dict:
    """Each key of a packed input dict -> its lane dim, cut over `mesh`, or
    None (replicated on every rank). Raises where a lane axis does not
    divide over the mesh."""
    dims = {k: _LANE_DIM.get(k) for k in inp}
    for k, dim in dims.items():
        if dim is not None and inp[k].shape[dim] % mesh.size():
            raise ValueError(f"{k}: {inp[k].shape[dim]} lanes do not divide "
                             f"over {mesh.size()} ranks")
    return dims


def lane_slice(tree: dict, lane_dims: dict, lo: int, n: int) -> dict:
    """`tree` with each lane array cut to lanes [lo, lo + n) along its lane
    dim in `lane_dims` (a view); the other entries as they are."""
    return {k: v if lane_dims.get(k) is None
            else v.narrow(lane_dims[k], lo, n) for k, v in tree.items()}


def place(tree: dict, device: torch.device) -> dict:
    """Every entry (numpy or tensor) as a contiguous tensor on `device`:
    bool stays bool, the rest becomes int64. Lane slices are made
    contiguous here, once, since the kernels' wrappers refuse views."""
    out = {}
    for k, v in tree.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if t.dtype != torch.bool:
            t = t.long()
        out[k] = t.to(device).contiguous()
    return out


def lanes_per_rank(mesh: DeviceMesh, n_tx: int) -> int:
    """nTx over the mesh's ranks; raises where it does not divide."""
    n_dev = mesh.size()
    if n_tx % n_dev:
        raise ValueError(f"nTx={n_tx} must divide over {n_dev} devices")
    return n_tx // n_dev


def local_lanes(mesh: DeviceMesh, packed: dict, chains: dict,
                t_loc: int) -> tuple[dict, dict]:
    """This rank's lanes of a whole batch and of its chains, on its device,
    contiguous."""
    lo, dev = mesh.get_local_rank(AXIS) * t_loc, mesh_device(mesh)
    return (place(lane_slice(packed, _LANE_DIM, lo, t_loc), dev),
            place(lane_slice(chains, _CHAIN_LANE_DIM, lo, t_loc), dev))


def gather_lanes(x: torch.Tensor, dim: int,
                 mesh: DeviceMesh) -> torch.Tensor:
    """The ranks' `x` joined along `dim`, in rank order, on every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x, group=mesh.get_group(AXIS))
    return torch.cat(parts, dim=dim)


def sharded_lanes(inp: dict, chains: dict, n_tx: int, t_loc: int,
                  n_levels: int, max_fee_tx: int, mesh: DeviceMesh):
    """Phases A-E on this rank's `t_loc` lanes, with the rq-link windows
    cut from the gathered full width and the globally last lane marked.
    Returns (lane outputs, lane_ok (t_loc,), failures over every rank)."""
    dev = inp["old_state_root"].device
    start = mesh.get_local_rank(AXIS) * t_loc
    zero1 = fr.zeros((1,), dev)
    neighbors = []
    for key in rm.NEIGHBOR_KEYS:
        full = gather_lanes(inp[key], 1, mesh)
        neighbors += [w[..., start:start + t_loc].contiguous()
                      for w in rm._neighbors(full, zero1)]
    last_mask = (start + torch.arange(t_loc, device=dev)) == n_tx - 1
    lanes, lane_ok = rm.rollup_main_lanes(
        inp, chains, t_loc, n_levels, max_fee_tx,
        neighbors=tuple(neighbors), last_mask=last_mask)
    n_bad = (~lane_ok).sum()
    dist.all_reduce(n_bad, group=mesh.get_group(AXIS))
    return lanes, lane_ok, n_bad


def _sharded_step(inp, chains, n_tx, t_loc, n_levels, max_l1_tx,
                  max_fee_tx, mesh):
    """One rank's share of a batch: `inp` and `chains` hold its lanes (and
    every replicated array) on its device. Returns the replicated
    (outputs, ok)."""
    lanes, _, n_bad = sharded_lanes(inp, chains, n_tx, t_loc, n_levels,
                                    max_fee_tx, mesh)
    ok_all = (n_bad == 0) & (inp["im_on_chain"] <= 1).all()
    full_lanes = {k: gather_lanes(lanes[k], dim, mesh)
                  for k, dim in _TAIL_LANE_DIM.items()}
    out, tail_ok, _ = rm.global_tail(inp, full_lanes, n_tx, n_levels,
                                     max_l1_tx, max_fee_tx)
    return out, ok_all & tail_ok


def make_sharded_rollup_main(mesh: DeviceMesh, n_tx: int, n_levels: int,
                             max_l1_tx: int, max_fee_tx: int):
    """Returns run(packed) -> (outputs, ok) with the tx lanes cut over
    `mesh`. Every rank calls it with the whole packed batch (on any
    device); `build_chains` runs on the full width, then each rank moves
    its own lanes to its device. Every rank gets the same outputs."""
    t_loc = lanes_per_rank(mesh, n_tx)

    def run(packed: dict):
        chains = rm.build_chains(packed, n_tx, max_fee_tx)
        inp, ch = local_lanes(mesh, packed, chains, t_loc)
        return _sharded_step(inp, ch, n_tx, t_loc, n_levels, max_l1_tx,
                             max_fee_tx, mesh)

    return run
