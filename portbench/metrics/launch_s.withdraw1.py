"""The host's submission of the captured graph, seconds a call of one
lane: the port's span aot.launch around graph.replay() inside the timed
window."""

from portbench.metrics import port_spans


def read(run):
    return port_spans.span_seconds(run, "aot.launch")
