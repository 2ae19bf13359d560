"""The 95th percentile of every call's latency in the window."""

from portbench.metrics import common


def read(run):
    return common.percentile(run.latencies, 95)
