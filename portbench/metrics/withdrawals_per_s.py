"""Withdrawals verified over the window's seconds."""


def read(run):
    return sum(len(run.load.items[i]) for i, _, _ in run.calls) / run.window_s
