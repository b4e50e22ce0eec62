"""The port's training scripts run end to end on the CPU at a tiny size, each in a
subprocess at two intra-op threads (``OMP_NUM_THREADS=2``): the synthetic
training demo (its loss must fall) and the convergence run with its temporal
evaluation, whose two artifacts keep ``scripts/convergence_synthetic.py``'s
layout. Both subprocesses start together, from one module fixture, and each
test waits for its own. ``scripts/torch_soak.py`` needs a GPU and runs on
the card only.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


TIMEOUT_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts, started at once; the convergence run's basename."""
    base = tmp_path_factory.mktemp("convergence") / "conv"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    started = {}
    for name, script, args in (
            ("demo", "torch_demo_train_synthetic.py", ("--cpu", "--steps", "6")),
            ("convergence", "torch_convergence_synthetic.py",
             ("--cpu", "--steps", "4", "--eval-clips", "1", "--eval-frames", "2",
              "--epe-target", "1e9", "--out", str(base)))):
        started[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "scripts" / script), *args], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield started, base
    for proc in started.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return out


def test_demo_trains_and_the_loss_falls(runs):
    out = _finish(runs[0]["demo"])
    assert "device cpu" in out and "DEMO OK" in out


def test_convergence_run_writes_both_artifacts(runs):
    started, base = runs
    out = _finish(started["convergence"])
    rows = [json.loads(line) for line in base.with_suffix(".jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    for r in rows:
        assert set(r) == {"step", "loss", "epe", "grad_norm"}
        assert all(v == v and abs(v) < float("inf") for v in r.values())
    md = base.with_suffix(".md").read_text()
    assert md.startswith("# Synthetic convergence curve")
    assert "| steps | mean EPE (px) | mean loss |" in md
    assert "first-1 EPE" in md and "last-1 EPE" in md
    assert "## Temporal mechanism (carried state vs reset)" in md
    for key in ("iters5_clean", "iters1_clean", "iters5_occluded"):
        assert f"| {key} | **" in md
    record = json.loads(out.strip().splitlines()[-1])
    assert record["metric"] == "synthetic_final_epe" and record["steps"] == 4
    assert set(record["temporal"]) == {"iters5_clean", "iters1_clean", "iters5_occluded"}
