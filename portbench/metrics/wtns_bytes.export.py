"""Bytes of the .wtns file a handed-off batch: the counter wtns_bytes of the
port's spans export.write inside the timed window, over their number."""

from portbench.metrics import per_batch


def read(run):
    return per_batch.mean(run, "export.write",
                          lambda r: (r["counters"] or {}).get("wtns_bytes"))
