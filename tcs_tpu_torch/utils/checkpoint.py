"""Weights-only checkpoints in the reference's ``.pth`` format.

A reference checkpoint (``train_stereo.py:260-269``,
``tools/convert_torch_ckpt.py:3-8``) is a dict with ``'model'``, or a bare
state dict, with or without the ``module.`` prefix of DDP. The port's
parameter names are the reference's, so such a file loads into ``TCStereo``
as it is, and a file written by :func:`save_weights` converts into
``tcs_tpu``'s parameters through ``tools/convert_torch_ckpt.py``.

Loading is strict: missing or unexpected entries raise, listed. The one
exception is BatchNorm's running statistics, which the port's batch norm has
no use for (it normalises with the batch's statistics in test mode too, as
``tcs_tpu`` does); they are skipped and counted. Optimiser state, the step
and resuming come with the trainer (ROADMAP Queue 1, item 3).
"""

from __future__ import annotations

import logging
import os
from typing import Dict

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
