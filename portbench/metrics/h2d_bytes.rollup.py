"""Bytes the pack copies to the device a call: the counter h2d_bytes of
the port's span witness.pack.h2d inside the timed window."""

from portbench.metrics import port_spans


def read(run):
    return port_spans.counter(run, "witness.pack.h2d", "h2d_bytes")
