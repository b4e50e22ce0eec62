"""The data-parallel cell on the CPU at a size a test can hold: two ranks over
Gloo, each with a batch of 2 clips of 128×256 (a global batch of 4), 2
frames, 2 iterations, the cell's own limits.

The block reference equals the single-process reference on the whole batch;
a run of the program is correct; the control (the reference in fp8 in the
program's place), a state left unchanged and each planted fault of
``benchmark.lib.ddp_faults`` are not; a rank killed in the window ends the
run with an error. The all-reduce readers are worked out by hand.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark.lib import collectives, harness, scenes, weights
from benchmark.reference.model import Arch, TCStereo as RefNet
from benchmark.reference.train import Step
from benchmark.reference.train_blocks import BlockStep

ROOT = Path(__file__).resolve().parents[2]
# Parked: the program's bf16 step goes non-finite inside a window (PERF.md,
# Open questions), so BENCHMARK.json does not hold the cell yet; its entries
# wait in benchmark/parked/.
CELL, CONFIG, TRAFFIC = "sceneflow-train-ddp4", "tcstereo-sceneflow-ddp4", "train_ddp"
SMALL = dict(image_size=[128, 256], train_iters=2, batch_size=2, frame_length=2)


def _context(seconds: float = 0.0, trace: bool = False, seed: int = 2**31 + 7):
    """The cell's context at the test's size, on two ranks."""
    cfg = harness.load_json(f"benchmark/configs/{CONFIG}.json")
    tr = harness.load_json(f"benchmark/traffic/{TRAFFIC}.json")
    cfg["train"].update(SMALL)
    tr.update(ranks=2, trace_steps=1, stall_s=120)
    return harness.Context(cell=CELL, config=cfg, traffic=tr,
                           limits=harness.load_json(f"benchmark/limits/{CELL}.json"),
                           seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"),
                           t0=time.perf_counter(), log=lambda msg: None)


def _parked() -> dict:
    """The entries that BENCHMARK.json takes to hold the cell."""
    return harness.load_json(f"benchmark/parked/{CELL}.json")


def test_the_cell_resolves_to_its_files():
    cfg = harness.load_json(f"benchmark/configs/{CONFIG}.json")
    assert cfg["name"] == CONFIG and cfg["gpus"] == 4 and cfg["train"]["batch_size"] == 4
    parked = harness.load_json("benchmark/configs/tcstereo-sceneflow.json")
    assert cfg["model"] == parked["model"] and cfg["train"] == parked["train"]
    tr = harness.load_json(f"benchmark/traffic/{TRAFFIC}.json")
    assert (harness.BENCH / "drivers" / f"{tr['driver']}.py").is_file()
    limits = harness.load_json(f"benchmark/limits/{CELL}.json")
    assert limits["checks"] and all("limit" in c for c in limits["checks"].values())
    entries = _parked()
    (config,), (cell,) = entries["configs"], entries["workloads"]
    assert config["file"] == f"benchmark/configs/{CONFIG}.json"
    assert config["reduced"] == cfg["reduced"]
    assert (cell["name"], cell["config"], cell["traffic"], cell["chips"]) == (
        CELL, CONFIG, TRAFFIC, 4)
    metrics = entries["end_to_end"] + entries["per_layer"]
    e2e = {m["name"] for m in entries["end_to_end"]} | {"setup_s"}
    for m in metrics:
        assert m["workloads"] == [CELL], m["name"]
        assert m["name"] in e2e or m["moves"] in e2e, m["name"]
    for name in [m["name"] for m in metrics] + ["setup_s"]:
        reader = harness.load_module(harness.BENCH / "metrics" / f"{name}.py")
        assert reader.read({"kind": "stream"}) is None, name


def test_the_parked_entries_keep_the_names_of_benchmark_json():
    """Merged into BENCHMARK.json they add names, change none, and keep
    the four-chip cells within a quarter of the cells."""
    bench = harness.load_json("BENCHMARK.json")
    for group, added in _parked().items():
        names = [e["name"] for e in bench[group] + added]
        assert len(names) == len(set(names)), group
    cells = bench["workloads"] + _parked()["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    layers = {m["layer"] for m in bench["per_layer"]}
    assert {m["layer"] for m in _parked()["per_layer"]} - layers == {"train step",
                                                                      "data parallel"}


def _driver():
    return harness.load_module(harness.BENCH / "drivers" / "train_ddp.py")


def _failing(ctx, fault=None) -> set:
    """The names of the run's numbers over their limits (none: correct)."""
    rec = _driver().run(ctx, fault)
    checks = harness.judged(rec["readings"], ctx.limits)
    checks["failed_calls"] = {"value": rec["failed"], "limit": 0}
    return {n for n, c in checks.items() if not c["value"] <= c["limit"]}


def test_blocks_equal_the_whole_batch_step():
    ctx = _context()
    recipe = dict(ctx.config["train"], init_thres=ctx.config["model"]["init_thres"])
    arch = Arch.from_config(ctx.config["model"])
    H, W = SMALL["image_size"]
    sd = weights.make(arch, 5, "cpu")
    batches = []
    for s in range(2):
        cl = scenes.clips(4, 2, H, W, scenes.principal_k(W / 2, H, W), 0.5, 11 + 4 * s)
        batches.append({k: torch.as_tensor(np.stack([np.asarray(c[k], np.float32) for c in cl]))
                        for k in ("image1", "image2", "flow", "valid", "T", "K", "baseline")})
    got = []
    for make in (lambda net: Step(net, recipe), lambda net: BlockStep(net, recipe, 2)):
        net = RefNet(arch)
        net.load_state_dict(sd)
        step = make(net)
        got.append([step(b) for b in batches])
    for whole, blocks in zip(*got):
        for key in ("loss", "grad_norm"):
            assert float(blocks[key]) == pytest.approx(float(whole[key]), rel=1e-5), key


def test_the_program_is_correct():
    assert _failing(_context()) == set()


@pytest.mark.parametrize("fault,caught_by", [
    ("half", "loss_rel"), ("unsynced", "grad_leaf"), ("left_out", "grad_leaf"),
    ("averaged", "grad_norm_rel"), ("swapped", "loss_rel")])
def test_a_planted_fault_is_not_correct(fault, caught_by):
    assert caught_by in _failing(_context(), fault)


def test_the_control_is_not_correct():
    ctx = _context()
    ctx.program = _driver().control
    assert _failing(ctx)


def test_state_left_unchanged():
    with mock.patch.object(torch.optim.AdamW, "step", lambda self, closure=None: None):
        assert {"grad_leaf", "change_leaf", "grad_diff_q25_leaf"} <= _failing(_context())


_KILLED_RUN = """
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
from test_bench_ddp import _context, _driver
if __name__ == "__main__":
    _driver().run(_context(seconds=300.0))
    print("the run ended")
"""


def _children(pid: int) -> list:
    out = []
    for task in Path(f"/proc/{pid}/task").iterdir():
        out += [int(c) for c in (task / "children").read_text().split()]
    return out


def test_a_killed_rank_ends_the_run(tmp_path):
    """SIGKILL to rank 1 in the window: rank 0 says so and exits 1 within
    seconds, with no process left and nothing on standard output."""
    script = tmp_path / "killed_run.py"
    script.write_text(_KILLED_RUN.format(root=str(ROOT), tests=str(Path(__file__).parent)))
    proc = subprocess.Popen([sys.executable, str(script)], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        deadline = time.monotonic() + 240
        workers = []
        while not workers and time.monotonic() < deadline:
            time.sleep(1)
            workers = [c for c in _children(proc.pid)
                       if b"spawn_main" in Path(f"/proc/{c}/cmdline").read_bytes()]
        assert workers, "no rank was spawned"
        time.sleep(45)  # into the window: set-up takes some 15 s at this size
        assert proc.poll() is None
        os.kill(workers[0], signal.SIGKILL)
        killed = time.monotonic()
        out, err = proc.communicate(timeout=60)
        assert time.monotonic() - killed < 30
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 1
    assert "rank 1 ended with exit code -9" in err
    assert out == ""
    assert not Path(f"/proc/{workers[0]}").exists()


def _record(device):
    summary = {"window_us": 1000.0, "busy_us": 400.0, "device": device, "gaps": [], "spans": {}}
    return {"kind": "train", "traced": {"calls": 2, "summary": summary}}


def test_allreduce_readers():
    device = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "reduce", "kernel", 0.0, 100.0),
              ("sm90_xmma_fprop", "conv", "kernel", 50.0, 100.0),
              ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "reduce", "kernel", 300.0, 50.0),
              ("Memcpy HtoD (Pageable -> Device)", "memcpy", "memcpy", 320.0, 10.0)]
    rec = _record(device)
    assert collectives.allreduce_ms_per_step(rec) == pytest.approx(0.075)
    # 50 µs of the first outside the conv, 40 of the second outside the copy
    assert collectives.allreduce_exposed_ms_per_step(rec) == pytest.approx(0.045)


def test_allreduce_readers_find_nothing_without_nccl():
    rec = _record([("sm90_xmma_fprop", "conv", "kernel", 50.0, 100.0)])
    assert collectives.allreduce_ms_per_step(rec) is None
    assert collectives.allreduce_exposed_ms_per_step(rec) is None
    assert collectives.allreduce_ms_per_step({"kind": "stream"}) is None
