"""Training driver (the port's copy of ``tcs_tpu/train/trainer.py``;
reference ``train_stereo.py:272-450``).

Builds the recipe's dataset and loader, a seeded model on the device and its
train step; resumes from the newest full checkpoint of the run, or else
starts from ``restore_ckpt``'s weights; trains, checkpointing every
``validation_frequency`` steps while the failure detector is clean and then
calling the ``validate_fn`` hook; checkpoints and returns on SIGTERM; saves a
final checkpoint. One process, one device: data parallelism over several
(DDP) is not ported yet, and the trainer refuses a process group of more
than one rank.

Three faults of ``tcs_tpu``'s trainer are not copied:
- resume: ``tcs_tpu`` restores the step but starts the data at epoch 1
  again (``tcs_tpu/train/trainer.py:125-131``); the port saves the loader's
  epoch and batch in each checkpoint and goes on from there;
- divergence before any checkpoint: ``tcs_tpu`` resets its detector and
  trains on from the poisoned state (``:157-171``); the port raises;
- ``restore_ckpt`` on a restarted run: ``tcs_tpu`` loads those initial
  weights again in place of the run's own checkpoint (``:76-91``); the port
  resumes the run, and takes ``restore_ckpt`` only when the run has none.

Each step appends one record to ``<checkpoint_dir>/<name>_steps.jsonl``: the
step, the loader's epoch, batch and sample indices, the host time blocked
waiting for the loader (``data_wait_ms``), queueing the batch's copy to the
device (``h2d_ms``; the loader has put it in pinned memory), the step up to its metrics on the host
(``step_ms``), all three with the record's writing (``wall_ms``), the
kernels' launches, the loss, the gradient norm and the device's peak memory.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
from typing import Callable, Dict, Optional

import torch

from tcs_tpu_torch.config import TrainConfig
from tcs_tpu_torch.data.datasets import fetch_dataset
from tcs_tpu_torch.data.loader import SequenceLoader
from tcs_tpu_torch.device import resolve
from tcs_tpu_torch.models import TCStereo
from tcs_tpu_torch.ops import _kernels
from tcs_tpu_torch.train.train_step import SequenceBatch, make_train_step
from tcs_tpu_torch.utils.checkpoint import CheckpointManager, load_weights
from tcs_tpu_torch.utils.debug import FailureDetector
from tcs_tpu_torch.utils.logging_utils import MetricsLogger
from tcs_tpu_torch.utils.profiling import StepTimer, device_memory_stats

logger = logging.getLogger(__name__)


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None, use_wandb: bool = False):
        if (torch.distributed.is_available() and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise RuntimeError("the trainer runs as one process on one device; data "
                               "parallelism over several ranks (DDP) is not ported yet")
        self.cfg = cfg
        self.device = resolve(device)
        self.model = TCStereo(cfg.model, device=self.device, seed=cfg.seed)
        self.step_fn = make_train_step(self.model, cfg)
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(cfg.checkpoint_dir, cfg.name))
        self.steps_path = os.path.join(cfg.checkpoint_dir, f"{cfg.name}_steps.jsonl")
        self.logger = MetricsLogger(
            sum_freq=100, frame_length=cfg.frame_length, use_wandb=use_wandb,
            jsonl_path=os.path.join(cfg.checkpoint_dir, f"{cfg.name}_metrics.jsonl"))
        logger.info("Parameter count: %d", sum(p.numel() for p in self.model.parameters()))

    def init_state(self):
        """(step, epoch, batch) to start from, with the model, optimiser and
        schedule restored where the run has a checkpoint."""
        if self.ckpt.latest_step() is not None:
            s = self.ckpt.restore(self.model, self.step_fn.optimizer, self.step_fn.scheduler)
            logger.info("Resumed at step %d (epoch %d, batch %d)", s["step"], s["epoch"],
                        s["batch"])
            return s["step"], s["epoch"], s["batch"]
        path = self.cfg.restore_ckpt
        if path:
            if os.path.isdir(path):
                CheckpointManager(path).restore_params_only(self.model)
            else:
                load_weights(self.model, path)
            logger.info("Restored weights from %s", path)
        return 0, 1, 0

    def _save(self, step: int, epoch: int, batch: int) -> None:
        self.ckpt.save(step, self.model, self.step_fn.optimizer, self.step_fn.scheduler,
                       epoch, batch, self.cfg)

    def train(self, max_steps: Optional[int] = None, dataset=None,
              validate_fn: Optional[Callable[[TCStereo, object], Dict]] = None) -> Dict:
        """Train to ``max_steps`` (the config's ``num_steps`` by default);
        returns where it stopped: step, epoch, batch and whether a SIGTERM
        stopped it. ``validate_fn(model, model_cfg)`` returns a metric dict."""
        cfg = self.cfg
        num_steps = max_steps or cfg.num_steps
        step, epoch, position = self.init_state()
        dataset = dataset if dataset is not None else fetch_dataset(cfg)
        loader = SequenceLoader(dataset, batch_size=cfg.batch_size, seed=cfg.seed,
                                num_workers=cfg.num_workers,
                                pin_memory=self.device.type == "cuda")
        detector = FailureDetector(patience=3)
        timer = StepTimer()
        preempted = {"flag": False}

        def on_sigterm(signum, frame):
            preempted["flag"] = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread
            prev_handler = None
        t_start = last = time.perf_counter()
        try:
            with loader, open(self.steps_path, "a") as record_file:
                batches = loader.stream(epoch, position)
                try:
                    while step < num_steps and not preempted["flag"]:
                        t0 = time.perf_counter()
                        epoch, k, np_batch = next(batches)
                        t1 = time.perf_counter()
                        batch = SequenceBatch.from_loader(np_batch, self.device)
                        t2 = time.perf_counter()
                        before = dict(_kernels.launches)
                        metrics = self.step_fn(batch)
                        healthy = detector.update(metrics)  # reads them: waits for the step
                        t3 = time.perf_counter()
                        step, position = step + 1, k + 1
                        timer.tick()
                        self.logger.push(metrics)
                        memory = device_memory_stats(self.device)
                        record = {
                            "step": step, "epoch": epoch, "batch": k,
                            "index": np_batch["index"].tolist(),
                            "data_wait_ms": 1e3 * (t1 - t0), "h2d_ms": 1e3 * (t2 - t1),
                            "step_ms": 1e3 * (t3 - t2),
                            "launches": {n: v - before[n] for n, v in _kernels.launches.items()},
                            "live_loss": float(metrics["live_loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "peak_gib": (memory["peak_allocated"] / 2**30 if memory else None)}
                        record["wall_ms"] = 1e3 * (time.perf_counter() - last)
                        record_file.write(json.dumps(record) + "\n")
                        record_file.flush()
                        last = time.perf_counter()
                        if not healthy:
                            if self.ckpt.latest_step() is None:
                                raise RuntimeError(
                                    f"training diverged at step {step} (loss "
                                    f"{record['live_loss']}, grad norm {record['grad_norm']})"
                                    " before any checkpoint was written; nothing to go back to")
                            s = self.ckpt.restore(self.model, self.step_fn.optimizer,
                                                  self.step_fn.scheduler)
                            logger.error("divergence at step %d: back to the checkpoint of "
                                         "step %d, the data goes on", step, s["step"])
                            step = s["step"]
                            detector.consecutive_bad = 0
                        vf = cfg.validation_frequency
                        if not preempted["flag"] and step % vf == vf - 1:
                            # never checkpoint a state the detector doubts
                            if healthy and detector.consecutive_bad == 0:
                                self._save(step, epoch, position)
                            if validate_fn is not None:
                                self.logger.write_dict(validate_fn(self.model, cfg.model))
                finally:
                    batches.close()
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        if preempted["flag"]:
            logger.warning("SIGTERM: checkpointing at step %d and stopping", step)
        self._save(step, epoch, position)
        logger.info("Stopped at step %d after %.1f s (%.3f steps/s over the later steps)",
                    step, time.perf_counter() - t_start, timer.steps_per_second)
        return {"step": step, "epoch": epoch, "batch": position,
                "preempted": preempted["flag"]}
