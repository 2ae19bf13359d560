"""The handoff's evaluation, seconds a call: the port's span export.evaluate
(the pack and the debug graph's replay up to the verdict) inside the timed
window."""

from portbench.metrics import port_spans


def read(run):
    return port_spans.span_seconds(run, "export.evaluate")
