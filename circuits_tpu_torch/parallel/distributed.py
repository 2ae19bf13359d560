"""Several processes, one mesh: the torch.distributed entry point and the
global mesh and input helpers.

Port of `circuits_tpu/parallel/distributed.py`. The reference is
single-host (pthreads inside one witness binary); sharding the tx-lane axis
over the ranks of several processes is this framework's extension of the
same im-signal contract (src/rollup-main.circom:93-99). The rq-link
all-gathers and the verdict all-reduce of `parallel/sharding.py` then cross
the process boundary over the process group's backend: NCCL between cards,
gloo on the CPU (and for two ranks that share one card, which NCCL
refuses).

Usage (one call a process, before any collective):

    from circuits_tpu_torch.parallel import distributed
    distributed.initialize("host0:1234", 2, 0)   # coordinator, world, rank
    mesh = distributed.global_tx_mesh()          # device="cpu" for the CPU
    packed, chains = distributed.shard_batch(mesh, local_packed,
                                             local_chains)

Unlike the JAX function, `initialize` reads no environment variable: the
caller names the coordinator, the world size and the rank.
`scripts/multihost_worker.py` is one rank of such a run.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .sharding import make_tx_mesh, mesh_device, place


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None, backend: str | None = None) -> None:
    """`torch.distributed.init_process_group` on `tcp://<coordinator>`
    (idempotent). Does nothing for one process with no coordinator, so a
    single-process caller may call it unconditionally.

    Where there is a card, the rank's current CUDA device becomes
    `local_device_ids[process_id % len(local_device_ids)]` (every visible
    card when None). `backend` None means NCCL where there is a card and
    gloo where there is none; two ranks that share one card name "gloo"."""
    if dist.is_initialized():
        return
    if coordinator is None and (num_processes or 1) == 1:
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator, num_processes "
                         "and process_id of a run of several processes")
    cuda = torch.cuda.is_available()
    if cuda:
        ids = list(local_device_ids
                   or range(torch.cuda.device_count()))
        torch.cuda.set_device(ids[process_id % len(ids)])
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def global_tx_mesh(device="cuda") -> DeviceMesh:
    """The 1-D "tx" mesh over every rank of the job, one device a rank, in
    rank order: rank i feeds lanes [i*T/n, (i+1)*T/n)."""
    return make_tx_mesh(None, device)


def shard_batch(mesh: DeviceMesh, local_packed: dict, local_chains: dict):
    """This process's lane slices (numpy or tensors: the packed inputs and
    the chains cut to its lanes along each key's lane dim; the replicated
    arrays whole, the same on every rank) on its device, contiguous.
    Returns (packed, chains) for `sharding._sharded_step`."""
    dev = mesh_device(mesh)
    return place(local_packed, dev), place(local_chains, dev)
