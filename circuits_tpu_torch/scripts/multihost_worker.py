"""One rank of a tx-lane sharded RollupMain run over torch.distributed.

    python -m circuits_tpu_torch.scripts.multihost_worker <rank> <world> \\
        <port> <batch file> [--device cpu] [--backend gloo]

Port of `scripts/multihost_worker.py`. The parent writes one batch file
(`write_batches`): the circuit's four parameters, the packed batches to run
and the packed batches to check, every tensor on the CPU. Each of the
`world` processes joins the group at `localhost:<port>`, cuts its lanes of
each batch, puts them on its device with `shard_batch` and runs
`_sharded_step`; then `check_batch_sharded` on each batch to check. The
rank's device is the card unless `--device cpu`; the backend is NCCL on
the card and gloo on the CPU unless `--backend` names one (two ranks that
share one card need gloo). It prints one line `MULTIHOST_RESULT <json>`
(every run's verdict, outputs as limbs, hash, kernel launches and seconds;
every check's verdict, lane and fee-slot masks and seconds), then
`MULTIHOST_OK <rank> <hash>` with the first run's hash, and leaves its
process group before it exits.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from .. import kernels
from ..field import fr
from ..models.rollup_main import build_chains
from ..parallel import distributed, sharding
from ..r1cs.checker import check_batch_sharded


def write_batches(path, params, runs, checks=()) -> None:
    """Write the batch file: `params` (nTx, nLevels, maxL1Tx, maxFeeTx),
    `runs` and `checks` lists of packed dicts (any device)."""
    def cpu(packed):
        return {k: v.detach().cpu() for k, v in packed.items()}

    torch.save(dict(params=[int(p) for p in params],
                    runs=[cpu(p) for p in runs],
                    checks=[cpu(p) for p in checks]), path)


def run_rank(mesh, data: dict) -> dict:
    """Every run and check of a loaded batch file on this rank."""
    n_tx, n_levels, max_l1_tx, max_fee_tx = data["params"]
    t_loc = sharding.lanes_per_rank(mesh, n_tx)
    lo, dev = mesh.get_local_rank(sharding.AXIS) * t_loc, \
        sharding.mesh_device(mesh)
    result = dict(device=str(dev), runs=[], checks=[])
    for packed in data["runs"]:
        chains = build_chains(packed, n_tx, max_fee_tx)
        inp, ch = distributed.shard_batch(
            mesh, sharding.lane_slice(packed, sharding._LANE_DIM, lo, t_loc),
            sharding.lane_slice(chains, sharding._CHAIN_LANE_DIM, lo, t_loc))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out, ok = sharding._sharded_step(inp, ch, n_tx, t_loc, n_levels,
                                         max_l1_tx, max_fee_tx, mesh)
        ok = bool(ok)  # waits for the device
        seconds = time.perf_counter() - t0
        result["runs"].append(dict(
            ok=ok, seconds=seconds,
            hash=fr.unpack_int(out["hash_global_inputs"]),
            outputs={k: v.cpu().tolist() for k, v in out.items()},
            launches={k: kernels.launches[k] for k in kernels.MAIN_PATH}))
    for packed in data["checks"]:
        t0 = time.perf_counter()
        res = check_batch_sharded(mesh, packed, n_tx, n_levels, max_l1_tx,
                                  max_fee_tx)
        result["checks"].append(dict(ok=res["ok"],
                                     seconds=time.perf_counter() - t0,
                                     lane_ok=res["lane_ok"].tolist(),
                                     fee_ok=res["fee_ok"].tolist()))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("batch_file")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    backend = args.backend or ("gloo" if args.device == "cpu" else None)
    distributed.initialize(f"localhost:{args.port}", args.world, args.rank,
                           backend=backend)
    try:
        mesh = distributed.global_tx_mesh(args.device)
        result = run_rank(mesh, torch.load(args.batch_file,
                                           weights_only=True))
        result["rank"] = args.rank
        print("MULTIHOST_RESULT " + json.dumps(result), flush=True)
        first = result["runs"][0]["hash"] if result["runs"] else None
        print(f"MULTIHOST_OK {args.rank} {first}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
