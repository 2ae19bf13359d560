from . import scalar, fr  # noqa: F401
