"""The port's trainer, full checkpoints and training CLI, on the CPU at a
small size (64x96 crops, 2 iterations, batch 1, 2-frame windows, the fp32
config) over trees fabricated from a seed.

- Resume is exact: 3 steps, a new trainer that resumes, and 3 more equal an
  uninterrupted 6-step run bit for bit, weights and optimiser state, and
  the two take the same batches across an epoch's end. Under tcs_tpu's rule
  (``tcs_tpu/train/trainer.py:125-131``: epoch 1 again on resume) the
  resumed steps would take other batches and this would fail.
- Divergence before any checkpoint raises; after one, the trainer goes back
  to it and trains on.
- A SIGTERM from a timer thread leaves a checkpoint at the step it stopped
  at, and the trainer returns.
- A full checkpoint's weights convert into tcs_tpu through
  ``tools/convert_torch_ckpt.py`` and give its forward within
  ``test_torch_model.py``'s 5e-2 px (measured 8.9e-6 px); this is the one
  JAX program the file compiles.
- ``cli/train.py`` maps every flag as ``scripts/train.py``'s ``build_config``
  does, without the TPU and multi-host flags, and trains in a subprocess
  with worker processes and validation; a SIGTERM to the subprocess's whole
  process group, its workers with it, leaves a checkpoint and exit code 0.
"""

import dataclasses
import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcs_tpu.config import ModelConfig as JaxModelConfig
from tcs_tpu.models import CameraParams as JaxCam
from tcs_tpu.models import TCStereo as JaxTCStereo
from tcs_tpu.models import TemporalState as JaxState
from tcs_tpu_torch.cli import train as cli
from tcs_tpu_torch.config import ModelConfig, TrainConfig
from tcs_tpu_torch.data import fabricate, kitti_raw_pose
from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState
from tcs_tpu_torch.train.trainer import Trainer
from tcs_tpu_torch.utils.checkpoint import CheckpointManager, save_weights
from tools.convert_torch_ckpt import convert_state_dict

# The test processes share the host: two intra-op threads each, so that
# several workers do not oversubscribe its cores.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
MCFG = ModelConfig(mixed_precision=False, corr_dtype="float32")
FLOW_TOL = 5e-2  # px, test_torch_model.py's bound


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer_tree"))
    # 2 drives x 2 windows of 2 frames: an epoch of 4 batches of 1
    fabricate.kitti_raw_tree(root, frames=3, height=80, width=112)
    kitti_raw_pose.main(["--root", os.path.join(root, "kitti_raw")])
    return root


def _cfg(tree, ckdir, **kw):
    base = dict(train_dataset="kitti_raw", data_root=tree, image_size=(64, 96), frame_length=2,
                batch_size=1, train_iters=2, num_steps=6, num_workers=0,
                spatial_scale=(-0.2, 0.2), saturation_range=(0.7, 1.3),
                checkpoint_dir=str(ckdir), validation_frequency=1000, model=MCFG)
    return TrainConfig(**{**base, **kw})


def _records(cfg):
    with open(os.path.join(cfg.checkpoint_dir, f"{cfg.name}_steps.jsonl")) as f:
        return [json.loads(line) for line in f]


def _state(trainer):
    opt = trainer.step_fn.optimizer.state_dict()
    tensors = [v for st in opt["state"].values() for v in st.values()]
    return list(trainer.model.state_dict().values()) + tensors


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    """A 6-step run, and 3 steps + resume + 3 steps, both from the same
    ``restore_ckpt`` weights."""
    d = tmp_path_factory.mktemp("runs")
    init = str(d / "init.pth")
    save_weights(TCStereo(MCFG, device="cpu", seed=21), init)
    whole = Trainer(_cfg(tree, d / "whole", restore_ckpt=init), device="cpu")
    stop = whole.train()
    cfg = _cfg(tree, d / "parts", restore_ckpt=init)
    first = Trainer(cfg, device="cpu").train(max_steps=3)
    second = Trainer(cfg, device="cpu")  # the run's own checkpoint wins over restore_ckpt
    last = second.train()
    return dict(whole=whole, parts=second, stop=stop, first=first, last=last,
                whole_cfg=whole.cfg, parts_cfg=cfg)


def test_resume_is_exact(runs):
    assert runs["stop"] == {"step": 6, "epoch": 2, "batch": 2, "preempted": False}
    assert runs["first"] == {"step": 3, "epoch": 1, "batch": 3, "preempted": False}
    assert runs["last"] == runs["stop"]
    pos = lambda r: (r["step"], r["epoch"], r["batch"], r["index"])  # noqa: E731
    whole, parts = _records(runs["whole_cfg"]), _records(runs["parts_cfg"])
    assert [pos(r) for r in parts] == [pos(r) for r in whole]
    assert [r["live_loss"] for r in parts] == [r["live_loss"] for r in whole]
    a, b = _state(runs["whole"]), _state(runs["parts"])
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_checkpoints_hold_the_full_state(runs):
    mgr = runs["whole"].ckpt
    assert mgr.steps() == [6]
    state = torch.load(mgr.path(6), map_location="cpu", weights_only=True)
    assert (state["step"], state["epoch"], state["batch"]) == (6, 2, 2)
    assert state["config"] == dataclasses.asdict(runs["whole_cfg"])
    assert set(state) == {"model", "optimizer", "scheduler", "step", "epoch", "batch", "config"}
    assert state["scheduler"]["last_epoch"] == 6
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]


def test_checkpoint_manager_keeps_five(tmp_path):
    model = TCStereo(MCFG, device="cpu", seed=1)
    opt = torch.optim.AdamW(model.parameters())
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    mgr = CheckpointManager(tmp_path / "ck")
    assert mgr.latest_step() is None
    for step in (2, 4, 6, 8, 10, 12, 14):
        mgr.save(step, model, opt, sched, 1, step, TrainConfig())
    assert mgr.steps() == [6, 8, 10, 12, 14] and mgr.latest_step() == 14
    other = TCStereo(MCFG, device="cpu", seed=2)
    mgr.restore_params_only(other, step=8)
    assert all(torch.equal(x, y) for x, y in zip(model.state_dict().values(),
                                                 other.state_dict().values()))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "none").restore_params_only(other)


def _fake_step(trainer, bad_steps):
    """The trainer's step with its metrics replaced: NaN on ``bad_steps``."""
    real, count = trainer.step_fn, [0]

    def step(batch):
        count[0] += 1
        v = float("nan") if count[0] in bad_steps else 1.0
        return {"live_loss": torch.tensor(v), "grad_norm": torch.tensor(v)}

    step.optimizer, step.scheduler = real.optimizer, real.scheduler
    trainer.step_fn = step


def test_divergence_before_any_checkpoint_halts(tree, tmp_path):
    trainer = Trainer(_cfg(tree, tmp_path), device="cpu")
    _fake_step(trainer, bad_steps={1, 2, 3})
    with pytest.raises(RuntimeError, match="diverged at step 3 .*before any checkpoint"):
        trainer.train()
    assert trainer.ckpt.latest_step() is None


def test_divergence_after_a_checkpoint_goes_back_to_it(tree, tmp_path):
    trainer = Trainer(_cfg(tree, tmp_path, validation_frequency=2, num_steps=5), device="cpu")
    _fake_step(trainer, bad_steps={2, 3, 4})
    stop = trainer.train()
    steps = [r["step"] for r in _records(trainer.cfg)]
    # saved at step 1 (1 % 2 == 2 - 1); steps 2-4 diverge; back to step 1 and on
    assert steps == [1, 2, 3, 4, 2, 3, 4, 5] and stop["step"] == 5
    assert [r["batch"] for r in _records(trainer.cfg)][4:] == [0, 1, 2, 3]  # the data goes on


def test_sigterm_leaves_a_checkpoint_and_returns(tree, tmp_path):
    cfg = _cfg(tree, tmp_path, num_steps=50)
    trainer = Trainer(cfg, device="cpu")
    path = os.path.join(cfg.checkpoint_dir, f"{cfg.name}_steps.jsonl")

    def kill_after_first_step():
        deadline = time.time() + 120
        while time.time() < deadline:
            if os.path.exists(path) and os.path.getsize(path) > 0:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.02)

    before = signal.getsignal(signal.SIGTERM)
    timer = threading.Thread(target=kill_after_first_step, daemon=True)
    timer.start()
    stop = trainer.train()
    timer.join(timeout=5)
    assert not timer.is_alive()
    assert stop["preempted"] and 1 <= stop["step"] < 50
    assert trainer.ckpt.latest_step() == stop["step"] == _records(cfg)[-1]["step"]
    assert signal.getsignal(signal.SIGTERM) is before


def test_trainer_refuses_more_than_one_rank(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(RuntimeError, match="DDP"):
        Trainer(_cfg(tree, tmp_path), device="cpu")


def test_full_checkpoint_converts_into_tcs_tpu(runs):
    """The converter reads the full checkpoint as it reads a weights file."""
    mgr = runs["whole"].ckpt
    ckpt = torch.load(mgr.path(6), map_location="cpu")  # as tools/convert_torch_ckpt.py loads
    sd = ckpt.get("model", ckpt)
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     convert_state_dict({k: v.numpy() for k, v in sd.items()}))
    jcfg = JaxModelConfig(mixed_precision=False, corr_dtype="float32")
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32) for _ in range(2))
    K = np.array([[[100.0, 0, 48], [0, 100.0, 32], [0, 0, 1]]], np.float32)
    T = np.eye(4, dtype=np.float32)[None]
    jo = JaxTCStereo(cfg=jcfg).apply(
        jparams, jnp.asarray(a), jnp.asarray(b), JaxState.zeros(1, 64, 96, jcfg),
        JaxCam(K=jnp.asarray(K), baseline=jnp.full((1,), 0.5)), jnp.asarray(T), iters=2,
        test_mode=True)
    model = runs["whole"].model
    with torch.no_grad():
        to = model(torch.from_numpy(a), torch.from_numpy(b),
                   TemporalState.zeros(1, 64, 96, MCFG, device="cpu"),
                   CameraParams(K=torch.from_numpy(K), baseline=torch.full((1,), 0.5)),
                   torch.from_numpy(T), iters=2)
    err = float(np.abs(np.asarray(jo.flow) - to.flow.numpy()).max())
    print(f"the converted checkpoint's flow against the port's: {err:.2e} px")
    assert err <= FLOW_TOL, err


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _reference_cli():
    spec = importlib.util.spec_from_file_location("reference_train_cli",
                                                  ROOT / "scripts" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FLAGS = ["--recipe", "TartanAir", "--data_root", "/data/x", "--checkpoint_dir", "/ckpt",
         "--restore_ckpt", "/ckpt/prev", "--num_steps", "17", "--batch_size", "3",
         "--lr", "5e-5", "--num_workers", "2", "--yjitter", "--train_dataset", "kitti",
         "--frame_length", "3", "--image_size", "96", "128", "--do_flip", "hf",
         "--name", "mapped", "--train_iters", "7", "--valid_iters", "9", "--wdecay", "1e-4",
         "--init_k", "2", "--spatial_scale", "-0.1", "0.3", "--saturation_range", "0.5", "1.1",
         "--img_gamma", "0.8", "1.2", "--init_thres", "0.6", "--corr_levels", "3",
         "--corr_radius", "5", "--n_downsample", "3", "--n_gru_layers", "3",
         "--hidden_dims", "96", "96", "96", "--context_norm", "batch", "--no_shared_backbone",
         "--slow_fast_gru", "--no_mixed_precision"]


@pytest.mark.parametrize("argv", [FLAGS, ["--recipe", "sceneflow", "--single_frame"],
                                  ["--recipe", "kitti_raw"],
                                  ["--recipe", "sceneflow", "--shared_backbone",
                                   "--mixed_precision"]],
                         ids=["every_flag", "single_frame", "no_flags", "enable_pairs"])
def test_cli_flags_land_as_in_scripts_train(argv):
    ref = _reference_cli()
    ours, theirs = cli.build_config(cli.parse_args(argv)), ref.build_config(ref.parse_args(argv))
    for f in dataclasses.fields(ours):
        if f.name != "model":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    for f in dataclasses.fields(ours.model):
        assert getattr(ours.model, f.name) == getattr(theirs.model, f.name), f.name


def test_cli_has_its_own_flags_and_not_the_tpu_ones():
    cfg = cli.build_config(cli.parse_args(["--recipe", "sceneflow", "--validation_frequency",
                                           "7"]))
    assert cfg.validation_frequency == 7
    assert cli.parse_args(["--recipe", "sceneflow"]).device == "cuda"
    for dropped in (["--frame_parallel_backward"], ["--frame_inline_backward"],
                    ["--coordinator", "h:1"], ["--num_processes", "2"], ["--process_id", "0"]):
        with pytest.raises(SystemExit):
            cli.parse_args(["--recipe", "sceneflow", *dropped])


def test_training_path_imports_without_pil_or_opencv():
    blocked = "import sys; sys.modules['PIL'] = sys.modules['cv2'] = None; "
    subprocess.run([sys.executable, "-c", blocked + "import tcs_tpu_torch.cli.train, "
                    "tcs_tpu_torch.train.trainer, tcs_tpu_torch.data.loader, "
                    "tcs_tpu_torch.data.kitti_raw_pose"], cwd=ROOT, check=True)


def test_cli_trains_with_worker_processes_and_validation(tmp_path):
    root = str(tmp_path)
    fabricate.tartanair_tree(root, sequences=(("gascola", "Easy", "P001"),  # held out
                                              ("gascola", "Easy", "P005")),
                             frames=4, height=80, width=112)
    out = subprocess.run(
        [sys.executable, "-m", "tcs_tpu_torch.cli.train", "--recipe", "TartanAir",
         "--device", "cpu", "--data_root", root, "--checkpoint_dir", os.path.join(root, "ck"),
         "--name", "cli", "--num_steps", "2", "--validation_frequency", "2", "--validate",
         "--image_size", "64", "96", "--frame_length", "2", "--batch_size", "1",
         "--train_iters", "1", "--valid_iters", "1", "--num_workers", "1",
         "--no_mixed_precision"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    ck = CheckpointManager(os.path.join(root, "ck", "cli"))
    assert ck.steps() == [1, 2]
    with open(os.path.join(root, "ck", "cli_metrics.jsonl")) as f:
        results = [json.loads(line) for line in f]
    assert any("TartanAir-epe" in r for r in results), results


def _children(pid: int) -> list:
    kids = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/stat") as f:
                if entry.isdigit() and int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                    kids.append(int(entry))
        except OSError:  # not a process, or it has just ended
            pass
    return kids


def _ignores(pid: int, signum: int) -> bool:
    with open(f"/proc/{pid}/status") as f:
        mask = int(next(line for line in f if line.startswith("SigIgn:")).split()[1], 16)
    return bool(mask >> (signum - 1) & 1)


def test_cli_checkpoints_when_its_process_group_is_signalled(tmp_path):
    root = str(tmp_path)
    fabricate.tartanair_tree(root, sequences=(("gascola", "Easy", "P005"),),
                             frames=4, height=80, width=112)
    ck = os.path.join(root, "ck")
    steps = os.path.join(ck, "grp_steps.jsonl")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tcs_tpu_torch.cli.train", "--recipe", "TartanAir",
         "--device", "cpu", "--data_root", root, "--checkpoint_dir", ck, "--name", "grp",
         "--num_steps", "1000", "--image_size", "64", "96", "--frame_length", "2",
         "--batch_size", "1", "--train_iters", "1", "--num_workers", "2",
         "--no_mixed_precision"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        deadline = time.time() + 300
        while not (os.path.exists(steps) and os.path.getsize(steps) > 0):
            assert proc.poll() is None and time.time() < deadline, proc.poll()
            time.sleep(0.05)
        # Its workers (and multiprocessing's resource tracker) would die at
        # once and leave the trainer waiting on a broken pool.
        kids = _children(proc.pid)
        assert len(kids) >= 2 and all(_ignores(k, signal.SIGTERM) for k in kids), kids
        os.killpg(proc.pid, signal.SIGTERM)  # as a job scheduler preempts: the whole group
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    assert proc.returncode == 0, out[-3000:]
    with open(steps) as f:
        last = json.loads(f.read().splitlines()[-1])["step"]
    assert 1 <= last < 1000
    assert CheckpointManager(os.path.join(ck, "grp")).latest_step() == last
