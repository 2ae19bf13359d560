"""Set-up seconds: from the process's start to the end of the warm-up (input
build, library, first call, capture)."""


def read(run):
    return run.setup_s
