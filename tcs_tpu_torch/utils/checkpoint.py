"""Checkpoints: weights in the reference's ``.pth`` format, and the
trainer's full-state checkpoints, whose weights are in that format too.

A reference checkpoint (``train_stereo.py:260-269``,
``tools/convert_torch_ckpt.py:3-8``) is a dict with ``'model'``, or a bare
state dict, with or without the ``module.`` prefix of DDP. The port's
parameter names are the reference's, so such a file loads into ``TCStereo``
as it is, and a file written by :func:`save_weights` converts into
``tcs_tpu``'s parameters through ``tools/convert_torch_ckpt.py``.

Loading is strict: missing or unexpected entries raise, listed. The one
exception is BatchNorm's running statistics, which the port's batch norm has
no use for (it normalises with the batch's statistics in test mode too, as
``tcs_tpu`` does); they are skipped and counted.

:class:`CheckpointManager` keeps the trainer's full state, one file per step
(``ckpt_<step>.pth``): the weights under ``'model'``, so that
:func:`load_weights` and ``tools/convert_torch_ckpt.py`` read the file as
they read a weights file, beside the optimiser, the schedule, the step, the
loader's epoch and batch, and the run's config. Where ``tcs_tpu`` keeps its
state with Orbax (``tcs_tpu/utils/checkpoint.py:19-80``), the port writes
each file under a temporary name, flushes it to disk and renames it, so a
run stopped in the middle of a save leaves the last checkpoint whole.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

logger = logging.getLogger(__name__)

BATCHNORM_STATISTICS = ("running_mean", "running_var", "num_batches_tracked")


def read_state_dict(path) -> Dict[str, torch.Tensor]:
    """The state dict of a ``.pth`` file, on the CPU, without the ``module.``
    prefix."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint file not found: {path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: neither a state dict nor a dict with 'model'")
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def load_weights(model: nn.Module, path) -> nn.Module:
    """Load ``path`` into ``model`` in place; returns ``model``."""
    sd = read_state_dict(path)
    skipped = [k for k in sd if k.rsplit(".", 1)[-1] in BATCHNORM_STATISTICS]
    for k in skipped:
        del sd[k]
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"{path} does not fit the model: missing {missing},"
                       f" unexpected {unexpected}")
    model.load_state_dict(sd, strict=True)
    logger.info("loaded %d tensors from %s; skipped %d BatchNorm running statistics",
                len(sd), path, len(skipped))
    return model


def save_weights(model: nn.Module, path) -> None:
    """``{'model': state_dict}`` with CPU tensors, the reference's format."""
    torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               path)


class CheckpointManager:
    """Full training state in ``directory``, the newest ``max_to_keep``
    steps kept."""

    _NAME = re.compile(r"^ckpt_(\d+)\.pth$")

    def __init__(self, directory, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:09d}.pth")

    def steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(self._NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: nn.Module, optimizer, scheduler, epoch: int,
             batch: int, config: Any) -> str:
        """Write the state after ``step`` updates; the loader is to go on at
        batch ``batch`` of ``epoch``. Returns the file's path."""
        os.makedirs(self.directory, exist_ok=True)
        state = {
            "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict(),
            "step": int(step), "epoch": int(epoch), "batch": int(batch),
            "config": dataclasses.asdict(config),
        }
        path = self.path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def _read(self, step: Optional[int]) -> Dict[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, model: nn.Module, optimizer, scheduler,
                step: Optional[int] = None) -> Dict[str, Any]:
        """Load the state of ``step`` (the newest by default) into the three
        objects in place; returns its step, epoch, batch and config."""
        state = self._read(step)
        model.load_state_dict(state["model"], strict=True)
        optimizer.load_state_dict(state["optimizer"])
        scheduler.load_state_dict(state["scheduler"])
        return {k: state[k] for k in ("step", "epoch", "batch", "config")}

    def restore_params_only(self, model: nn.Module, step: Optional[int] = None) -> nn.Module:
        """The weights of ``step`` (the newest by default) alone
        (``--restore_ckpt`` on a directory of checkpoints)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return load_weights(model, self.path(step))
