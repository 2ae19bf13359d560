"""Fixtures of the benchmark's CPU tests: the checkout's root on the path,
one stand-in checkout for the module, and the card's presence decided in a
fixture (never while a module is imported)."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture(scope="module")
def standin_root(tmp_path_factory):
    from portbench.tests import standin

    return standin.make_root(tmp_path_factory.mktemp("standin"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
