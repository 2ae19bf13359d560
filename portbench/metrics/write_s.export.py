"""The .wtns file written, seconds a handed-off batch: the port's spans
export.write inside the timed window, their total over their number."""

from portbench.metrics import per_batch


def read(run):
    return per_batch.seconds(run, "export.write")
