"""Window seconds over RollupMain batches completed, input dict to host
outputs."""


def read(run):
    return run.window_s / len(run.calls)
