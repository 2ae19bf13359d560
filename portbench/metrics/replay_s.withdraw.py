"""Host span from run_packed to its synchronise (the graph replay), mean
seconds a call."""

from portbench.metrics import common


def read(run):
    return common.span_mean(run, "replay")
