"""K1 and K4's least time for the call's circuit work over their profiled
device time, in %."""

from portbench.metrics import common


def read(run):
    return common.roofline_share(run, ("K1", "K4"))
