"""The device's values brought to the host as the Python int vector, seconds
a handed-off batch: the port's spans export.read inside the timed window,
their total over their number."""

from portbench.metrics import per_batch


def read(run):
    return per_batch.seconds(run, "export.read")
