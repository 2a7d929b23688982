"""The benchmark's own tests: the harness and the reference on the CPU at
tiny sizes; ``gpu`` tests run a cell on a card and skip without one.

    python -m pytest benchmark/tests -q
"""
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: requires an NVIDIA CUDA card (skips without one)")


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
