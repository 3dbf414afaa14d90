"""Tests of the benchmark's harness. They run on the CPU at nano sizes; the
tests marked ``cuda`` need a card and skip without one (decided in the
``card`` fixture, never at import).

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.fixture
def nano_root(tmp_path, monkeypatch):
    """A throwaway checkout root: a copy of the benchmark's files, and a new
    BENCHMARK.json with nano cells made from new files alone."""
    from portbench.tests import nano

    monkeypatch.setenv("ZG2_KV_PACKED", "1")  # the card's packed layout, on the CPU
    return nano.make(tmp_path)
