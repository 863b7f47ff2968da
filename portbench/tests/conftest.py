"""Tests of the benchmark itself. Those marked `cuda` need an NVIDIA GPU
with the CUDA toolkit and skip elsewhere; whether there is one is decided
inside the `cuda_device` fixture, never while a module is imported."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU with the CUDA toolkit")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
