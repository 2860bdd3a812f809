"""The benchmark's own tests: `python -m pytest slambench/tests -q` from the
root of the repository. Tests marked `cuda` need the card and skip here."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark's cell sizes)")
    return torch.device("cuda")
