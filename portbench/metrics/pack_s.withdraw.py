"""Host span around the engine's pack (WithdrawEngine.pack), mean seconds a
call."""

from portbench.metrics import common


def read(run):
    return common.span_mean(run, "pack")
