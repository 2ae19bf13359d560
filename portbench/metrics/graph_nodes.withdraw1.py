"""Nodes of the captured graph (CapturedCall.nodes, read from the graph)."""


def read(run):
    return run.counters.get("graph_nodes") or None
