"""On a card: one short run of each cell through the command the driver
runs, with ``correct`` true and a contract-shaped last line. Skips
without a card."""
import json
import subprocess
import sys

import pytest

from bench_tiny import CELLS
from harness import cells


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 101), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert {m["name"] for m in cells.find_cell(name).end_to_end} == \
        set(res["metrics"])
