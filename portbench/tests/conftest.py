"""Fixtures of the benchmark's tests. Whether a card is there is decided
inside the ``cuda_device`` fixture, never while a module is imported."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
