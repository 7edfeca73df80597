"""The benchmark's tests. Tests that need a CUDA card carry the `card`
marker and take the `cuda_device` fixture, which skips them where there is
none; run them on the card with `python3 -m pytest portbench/tests -m card`.
The rest run on the CPU at tiny sizes."""

import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def in_repo(monkeypatch):
    """Run from the repository's root, as the benchmark's command does."""
    monkeypatch.chdir(REPO)
    return REPO
