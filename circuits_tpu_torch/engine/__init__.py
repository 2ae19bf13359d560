"""Witness engine: batch-builder inputs -> batched device tensors ->
captured circuit evaluation (port of `circuits_tpu/engine`)."""

from .witness import pack_rollup_inputs, RollupEngine, WithdrawEngine

__all__ = ["pack_rollup_inputs", "RollupEngine", "WithdrawEngine"]
