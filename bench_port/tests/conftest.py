"""Fixtures of the benchmark's tests: ``cuda`` skips a test without a
card, decided when the test runs, never at import."""

import pytest


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
