"""The captured graph's device seconds a call of one lane, with any wait
for its submission: the port's timing events aot.graph around
graph.replay()."""

from portbench.metrics import port_spans


def read(run):
    return port_spans.device_seconds(run, "aot.graph")
