"""The benchmark's parts that are found by name: each a Python file under a
folder of the checkout's `portbench/`, loaded as a module of its own, so
that a later change adds one with a file and never edits one that is
there.

    metrics/<metric>.py     `read(run)`, the metric's reader
    routes/<entry>.py       a mix's `entry`: the class the harness drives,
                            its judge and its control
    circuits/<circuit>.py   a configuration's `circuit`: the traffic's
                            build and the reference's answers
"""

from __future__ import annotations

import importlib.util
from pathlib import Path


class Refused(Exception):
    """A run that may print no result (exit code 2)."""


def load(root: Path, folder: str, name: str):
    """The module of `portbench/<folder>/<name>.py` under `root`; a run
    that names a part with no file is refused."""
    path = Path(root) / "portbench" / folder / f"{name}.py"
    if not path.is_file():
        raise Refused(f"{name!r} has no file: portbench/{folder}/{name}.py "
                      f"is missing")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}._" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
