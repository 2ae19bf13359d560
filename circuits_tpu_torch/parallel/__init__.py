"""Multi-device sharding of the witness engine over torch.distributed.

Port of `circuits_tpu/parallel/`. The tx-lane axis -- made embarrassingly
parallel by the circuit's im-signal contract
(src/rollup-main.circom:93-99) -- is cut into one contiguous slice a rank;
the cross-lane reads are explicit collectives: an all-gather of three small
per-tx arrays for the rq-link windows, an all-reduce of the failure counts
for the verdict, and an all-gather of the lane outputs that the replicated
global tail (fee transactions, SHA-256) reads.
"""

from .sharding import make_tx_mesh, make_sharded_rollup_main, tx_shardings

__all__ = ["make_tx_mesh", "make_sharded_rollup_main", "tx_shardings"]
