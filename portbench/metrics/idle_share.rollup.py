"""Profiler: the device's idle share of the profiled sub-window, in %."""

from portbench.metrics import common


def read(run):
    return common.idle_share(run)
