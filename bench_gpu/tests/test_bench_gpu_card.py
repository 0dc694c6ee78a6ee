"""Each cell, run briefly on the card as the driver runs it (marked
``cuda``; on the card: ``python3 -m pytest -m cuda bench_gpu/tests``)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, cell, trace):
    res = subprocess.run([sys.executable, "-m", "bench_gpu.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["metrics"]
    if trace:
        assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
