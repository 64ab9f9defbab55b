"""Shared fixtures of the benchmark's CPU tests: the nano cells under
``data/`` and the decision whether a card is there (made in a fixture,
never at import)."""

from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def roots():
    return [DATA]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
