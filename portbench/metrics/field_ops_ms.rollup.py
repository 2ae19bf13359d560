"""Profiler: device milliseconds a batch of every operation other than K1-K4."""

from portbench.metrics import common


def read(run):
    return _ms(common.kernel_seconds(run, ()))


def _ms(seconds):
    return None if seconds is None else seconds * 1e3
