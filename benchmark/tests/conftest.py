"""Shared set-up of the benchmark's CPU tests: the repository on the path, two
torch threads a process, and small contexts of the real cells."""

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

torch.set_num_threads(2)

SMALL_STREAM = dict(image_size=[60, 90], iters=2)
SMALL_TRAIN = dict(image_size=[128, 256], train_iters=2)


# Training cells whose configuration, traffic and limits are under benchmark/
# but not in BENCHMARK.json: the program's bf16 step goes non-finite after
# some tens of steps (PERF.md, Open questions). Their driver stays tested.
PARKED = {"kitti-train": ("tcstereo-kitti", "train_step"),
          "sceneflow-train": ("tcstereo-sceneflow", "train_step")}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(cell: str):
    """(config, traffic) of a cell of BENCHMARK.json or a parked one."""
    cells = {w["name"]: (w["config"], w["traffic"]) for w in bench()["workloads"]}
    return cells.get(cell) or PARKED[cell]


def small_context(cell: str, seed: int = 2**31 + 7, seconds: float = 0.0, trace: bool = False,
                  batch: int = 2, frames: int = 3):
    """The cell's context on the CPU at a size a test can hold: streams of
    60×90 frames (padded to 64×96), training crops of 128×256 (at 64×96 the
    bootstrap's argmax flips move a sound bf16 step's gradient past the
    cells' limits), ``batch`` streams or clips a batch, ``frames`` frames a
    scene or window, 2 iterations; the cell's own limits."""
    from benchmark.lib import harness

    config, traffic = cell_files(cell)
    cfg = harness.load_json(f"benchmark/configs/{config}.json")
    tr = harness.load_json(f"benchmark/traffic/{traffic}.json")
    cfg["stream"].update(SMALL_STREAM)
    cfg["train"].update(SMALL_TRAIN, batch_size=batch, frame_length=frames)
    tr.update(streams=batch, frames_per_scene=frames, warmup_calls=2, trace_calls=frames,
              trace_steps=1)
    return harness.Context(cell=cell, config=cfg, traffic=tr,
                           limits=harness.load_json(f"benchmark/limits/{cell}.json"),
                           seed=seed, seconds=seconds, trace=trace,
                           device=torch.device("cpu"), t0=time.perf_counter(),
                           log=lambda msg: None)


@pytest.fixture
def small():
    return small_context
