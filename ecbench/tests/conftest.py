"""The benchmark's own tests: run from the root of the checkout as

    python -m pytest ecbench/tests -q

Tests marked ``cuda`` run a cell on the card and skip, with a reason, where
there is none; they decide that inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")
