"""Fixtures of the benchmark's tests. Tests that need the card are marked
``cuda`` and take ``cuda_device``, which decides whether there is one."""
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
