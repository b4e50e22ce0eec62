"""Training driver (the port's copy of ``tcs_tpu/train/trainer.py``;
reference ``train_stereo.py:272-450``).

Builds the recipe's dataset and loader, a seeded model on the device and its
train step; resumes from the newest full checkpoint of the run, or else from
the newest ``tcs_tpu`` step in the run's directory, or else starts from
``restore_ckpt``'s weights; trains, checkpointing every
``validation_frequency`` steps while the failure detector is clean and then
calling the ``validate_fn`` hook; checkpoints and returns on SIGTERM; saves a
final checkpoint.

Under a process group (``parallel.mesh``, one process per card) the trainer
trains the model under DDP on ``tcs_tpu``'s global batch: each rank's loader
takes shard ``rank`` of ``world size`` with ``batch_size`` samples a batch,
and the step computes the losses, batch norm and metrics of the ranks'
batches stacked. Every decision reads the metrics summed over the ranks, so
every rank takes the same branch: the failure detector, and the SIGTERM
flag, which goes into that sum, so that a signal to any rank stops every
rank after the same step. Rank 0 alone writes the checkpoints and the
records; every rank restores the same checkpoint.

Three faults of ``tcs_tpu``'s trainer are not copied:
- resume: ``tcs_tpu`` restores the step but starts the data at epoch 1
  again (``tcs_tpu/train/trainer.py:125-131``); the port saves the loader's
  epoch and batch in each checkpoint and goes on from there;
- divergence before any checkpoint: ``tcs_tpu`` resets its detector and
  trains on from the poisoned state (``:157-171``); the port raises (a run
  resumed from ``tcs_tpu``'s step goes back to that step);
- ``restore_ckpt`` on a restarted run: ``tcs_tpu`` loads those initial
  weights again in place of the run's own checkpoint (``:76-91``); the port
  resumes the run, and takes ``restore_ckpt`` only when the run has none.

A run of ``tcs_tpu`` moves to the port as it stands: where the run's
directory (``checkpoint_dir/name``, the layout of
``tcs_tpu/train/trainer.py:48-50``) holds none of the port's checkpoints but
``tcs_tpu``'s Orbax steps, the newest step is resumed in full (weights,
AdamW's moments, the step and the learning rate;
``utils.checkpoint.restore_tcs_tpu``), and the loader goes on at the
position the step implies, ``divmod(step, batches per epoch)``, as the
port's own resume would; ``tcs_tpu`` itself would replay the data from
epoch 1 (the first fault above), which is not copied. ``restore_ckpt`` takes
whatever ``utils.checkpoint.load_any`` reads, ``tcs_tpu``'s Orbax
directories included, so the KITTI raw recipe can start from a TartanAir
run of ``tcs_tpu``. Under a process group each rank reads the checkpoint
onto its own device.

With ``deterministic`` the training runs under
``device.deterministic()``: on the card, cuDNN's deterministic convolution
algorithms, without which a resumed run need not retrace the uninterrupted
one (the fp32 config's step parts in the first loss between two runs); the
CPU's step is deterministic without it.

Each step appends one record to ``<checkpoint_dir>/<name>_steps.jsonl``: the
step, the loader's epoch, batch and the global batch's sample indices (every
rank's, in rank order), the host time blocked
waiting for the loader (``data_wait_ms``), queueing the batch's copy to the
device (``h2d_ms``; the loader has put it in pinned memory), the step up to its metrics on the host
(``step_ms``), all three with the record's writing (``wall_ms``), the
kernels' launches, the loss, the gradient norm and the device's peak memory.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import signal
import time
from typing import Callable, Dict, Optional

from tcs_tpu_torch import device as device_lib
from tcs_tpu_torch.config import TrainConfig
from tcs_tpu_torch.data.datasets import fetch_dataset
from tcs_tpu_torch.data.loader import SequenceLoader
from tcs_tpu_torch.models import TCStereo
from tcs_tpu_torch.ops import _kernels
from tcs_tpu_torch.parallel import mesh
from tcs_tpu_torch.train.train_step import SequenceBatch, make_train_step
from tcs_tpu_torch.utils import orbax_format
from tcs_tpu_torch.utils.checkpoint import CheckpointManager, load_any, restore_tcs_tpu
from tcs_tpu_torch.utils.debug import FailureDetector
from tcs_tpu_torch.utils.logging_utils import MetricsLogger
from tcs_tpu_torch.utils.profiling import StepTimer, device_memory_stats

logger = logging.getLogger(__name__)


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None, use_wandb: bool = False,
                 deterministic: bool = False):
        """``device``: 'cuda' (the default: this rank's card) or 'cpu';
        ``deterministic``: train under ``device.deterministic()``, which
        exact resume on the card needs."""
        self.cfg = cfg
        self.deterministic = deterministic
        self.device = mesh.local_device("cuda" if device is None else device)
        # every rank draws the same weights: DDP's broadcast changes nothing
        self.model = TCStereo(cfg.model, device=self.device, seed=cfg.seed)
        self.step_fn = make_train_step(mesh.wrap(self.model), cfg)
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(cfg.checkpoint_dir, cfg.name))
        self.steps_path = os.path.join(cfg.checkpoint_dir, f"{cfg.name}_steps.jsonl")
        self.logger = MetricsLogger(
            sum_freq=100, frame_length=cfg.frame_length, use_wandb=use_wandb,
            jsonl_path=os.path.join(cfg.checkpoint_dir, f"{cfg.name}_metrics.jsonl"))
        logger.info("Parameter count: %d", sum(p.numel() for p in self.model.parameters()))

    def init_state(self, batches_per_epoch: int):
        """(step, epoch, batch) to start from, with the model, optimiser and
        schedule restored where the run has a checkpoint of the port's or of
        ``tcs_tpu``'s."""
        if self.ckpt.latest_step() is not None:
            s = self._restore()
            logger.info("Resumed at step %d (epoch %d, batch %d)", s["step"], s["epoch"],
                        s["batch"])
            return s["step"], s["epoch"], s["batch"]
        if orbax_format.step_dirs(self.ckpt.directory):
            step = self._restore()["step"]
            epoch, batch = divmod(step, batches_per_epoch)
            logger.info("Resumed tcs_tpu's run at step %d (epoch %d, batch %d)", step,
                        epoch + 1, batch)
            return step, epoch + 1, batch
        path = self.cfg.restore_ckpt
        if path:
            load_any(self.model, path)
            logger.info("Restored weights from %s", path)
        return 0, 1, 0

    def _restore(self) -> Dict:
        """The newest checkpoint of the run, the port's, else ``tcs_tpu``'s
        (whose record is its step alone)."""
        opt, sched = self.step_fn.optimizer, self.step_fn.scheduler
        if self.ckpt.latest_step() is None:
            return {"step": restore_tcs_tpu(self.ckpt.directory, self.model, opt, sched)}
        return self.ckpt.restore(self.model, opt, sched, map_location=self.device)

    def _save(self, step: int, epoch: int, batch: int) -> None:
        self.ckpt.save(step, self.model, self.step_fn.optimizer, self.step_fn.scheduler,
                       epoch, batch, self.cfg)

    def train(self, max_steps: Optional[int] = None, dataset=None,
              validate_fn: Optional[Callable[[TCStereo, object], Dict]] = None) -> Dict:
        """Train to ``max_steps`` (the config's ``num_steps`` by default);
        returns where it stopped: step, epoch, batch and whether a SIGTERM
        stopped it. ``validate_fn(model, model_cfg)`` returns a metric dict;
        under a process group every rank calls it (the evaluators shard their
        sequences over the ranks)."""
        with device_lib.deterministic() if self.deterministic else contextlib.nullcontext():
            return self._train(max_steps, dataset, validate_fn)

    def _train(self, max_steps, dataset, validate_fn) -> Dict:
        cfg = self.cfg
        num_steps = max_steps or cfg.num_steps
        dataset = dataset if dataset is not None else fetch_dataset(cfg)
        loader = SequenceLoader(dataset, batch_size=cfg.batch_size, seed=cfg.seed,
                                shard_id=mesh.rank(), num_shards=mesh.world_size(),
                                num_workers=cfg.num_workers,
                                pin_memory=self.device.type == "cuda")
        step, epoch, position = self.init_state(len(loader))
        detector = FailureDetector(patience=3)
        timer = StepTimer()
        signalled = {"flag": False}  # on this rank
        stop = False  # on any rank, read with the step's metrics

        def on_sigterm(signum, frame):
            signalled["flag"] = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread
            prev_handler = None
        t_start = last = time.perf_counter()
        try:
            with loader, (open(self.steps_path, "a") if mesh.is_primary()
                          else contextlib.nullcontext()) as record_file:
                batches = loader.stream(epoch, position)
                try:
                    while step < num_steps and not stop:
                        t0 = time.perf_counter()
                        epoch, k, np_batch = next(batches)
                        t1 = time.perf_counter()
                        batch = SequenceBatch.from_loader(np_batch, self.device)
                        t2 = time.perf_counter()
                        before = dict(_kernels.launches)
                        metrics = self.step_fn(batch, extra={"sigterm": signalled["flag"]})
                        stop = float(metrics.pop("sigterm")) > 0  # waits for the step
                        healthy = detector.update(metrics)
                        t3 = time.perf_counter()
                        step, position = step + 1, k + 1
                        timer.tick()
                        self.logger.push(metrics)
                        memory = device_memory_stats(self.device)
                        record = {
                            "step": step, "epoch": epoch, "batch": k,
                            "index": loader.global_batch(epoch, k).tolist(),
                            "data_wait_ms": 1e3 * (t1 - t0), "h2d_ms": 1e3 * (t2 - t1),
                            "step_ms": 1e3 * (t3 - t2),
                            "launches": {n: v - before[n] for n, v in _kernels.launches.items()},
                            "live_loss": float(metrics["live_loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "peak_gib": (memory["peak_allocated"] / 2**30 if memory else None)}
                        record["wall_ms"] = 1e3 * (time.perf_counter() - last)
                        if record_file is not None:
                            record_file.write(json.dumps(record) + "\n")
                            record_file.flush()
                        last = time.perf_counter()
                        if not healthy:
                            if (self.ckpt.latest_step() is None
                                    and not orbax_format.step_dirs(self.ckpt.directory)):
                                raise RuntimeError(
                                    f"training diverged at step {step} (loss "
                                    f"{record['live_loss']}, grad norm {record['grad_norm']})"
                                    " before any checkpoint was written; nothing to go back to")
                            s = self._restore()
                            logger.error("divergence at step %d: back to the checkpoint of "
                                         "step %d, the data goes on", step, s["step"])
                            step = s["step"]
                            detector.consecutive_bad = 0
                        vf = cfg.validation_frequency
                        if not stop and step % vf == vf - 1:
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
        if stop:
            logger.warning("SIGTERM: checkpointing at step %d and stopping", step)
        self._save(step, epoch, position)
        logger.info("Stopped at step %d after %.1f s (%.3f steps/s over the later steps)",
                    step, time.perf_counter() - t_start, timer.steps_per_second)
        return {"step": step, "epoch": epoch, "batch": position, "preempted": stop}
