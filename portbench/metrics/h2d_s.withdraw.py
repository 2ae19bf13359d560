"""The pack's host-to-device copy, host seconds a call: the port's span
witness.pack.h2d inside the timed window (none on the CPU)."""

from portbench.metrics import port_spans


def read(run):
    return port_spans.span_seconds(run, "witness.pack.h2d")
