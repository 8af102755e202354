import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first card, or a skip where none is visible (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return "cuda:0"
