"""One short run of each cell on the card, through the benchmark's own
command. Marked ``cuda``: it skips without a card. On a machine with one:
``python -m pytest -q -m cuda benchmark/tests/test_bench_card.py``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card only")


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483999", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
