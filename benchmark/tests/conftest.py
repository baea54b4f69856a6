import pytest

from benchmark.tests.tiny import tiny_copy


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark cut to a size the CPU runs in a blink."""
    return tiny_copy(tmp_path)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
