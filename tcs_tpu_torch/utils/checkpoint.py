"""Checkpoints: weights in the reference's ``.pth`` format and in
``tcs_tpu``'s ``.npz`` format, and the trainer's full-state checkpoints,
whose weights are in the ``.pth`` format too.

A reference checkpoint (``train_stereo.py:260-269``,
``tools/convert_torch_ckpt.py:3-8``) is a dict with ``'model'``, or a bare
state dict, with or without the ``module.`` prefix of DDP. The port's
parameter names are the reference's, so such a file loads into ``TCStereo``
as it is, and a file written by :func:`save_weights` converts into
``tcs_tpu``'s parameters through ``tools/convert_torch_ckpt.py``.

``tcs_tpu``'s ``.npz`` (``tcs_tpu/utils/checkpoint.py:97-117``,
``save_params_npz`` / ``load_params_npz``) holds one array per parameter of
its ``{"params": tree}``, keyed by ``jax.tree_util.keystr`` of the leaf's
path (``"['params']['cnet']['conv1']['Conv_0']['bias']"``), fp16 by default:
``tests/fixtures/convergence_params.npz`` is such a file. The port reads and
writes it with numpy alone, through ``convert.state_dict_from_jax`` and
``convert.params_from_state_dict``.

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
run stopped in the middle of a save leaves the last checkpoint whole. Under a
process group (``parallel.mesh``) every rank calls ``save``: rank 0 alone
writes, and the ranks meet at a barrier after it, so that each then reads
the same newest checkpoint.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from tcs_tpu_torch import convert
from tcs_tpu_torch.parallel import mesh

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


_KEYSTR_PART = re.compile(r"\['([^'\]]+)'\]")


def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"['{k}']" for k in path)


def _parse_keystr(key: str):
    path = tuple(_KEYSTR_PART.findall(key))
    if not path or _keystr(path) != key:
        raise KeyError(f"not a key path of dict keys: {key!r}")
    return path


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_params_npz(model: nn.Module, path) -> nn.Module:
    """Load ``tcs_tpu``'s ``.npz`` parameter file into ``model`` in place
    (each array as float32); returns ``model``. Raises ``KeyError`` naming
    the file's keys if it holds a parameter the model lacks or lacks one the
    model has."""
    own = convert.params_from_state_dict(model.state_dict(), model.cfg.context_norm)
    want = {_keystr(p) for p, _ in _flatten(own)}
    tree: dict = {}
    with np.load(path) as data:
        missing, unexpected = sorted(want - set(data.files)), sorted(set(data.files) - want)
        if missing or unexpected:
            raise KeyError(f"{path} does not fit the model: missing {missing},"
                           f" unexpected {unexpected}")
        for key in data.files:
            node = tree
            *scopes, leaf = _parse_keystr(key)
            for k in scopes:
                node = node.setdefault(k, {})
            node[leaf] = data[key].astype(np.float32)
    model.load_state_dict(convert.state_dict_from_jax(tree, model.cfg.n_gru_layers),
                          strict=True)
    logger.info("loaded %d arrays from %s", len(want), path)
    return model


def save_params_npz(model: nn.Module, path, dtype: str = "float16") -> None:
    """``model``'s weights as ``tcs_tpu``'s ``.npz`` (``save_params_npz``
    there): ``tcs_tpu``'s ``load_params_npz`` reads the file into a tree of
    the same architecture."""
    tree = convert.params_from_state_dict(model.state_dict(), model.cfg.context_norm)
    np.savez_compressed(path, **{_keystr(p): v.astype(dtype) for p, v in _flatten(tree)})


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
        batch ``batch`` of ``epoch``. Returns the file's path. On rank 0 of a
        process group only, and every rank waits for it."""
        path = self.path(step)
        if mesh.is_primary():
            self._write(path, model, optimizer, scheduler, step, epoch, batch, config)
        mesh.barrier()
        return path

    def _write(self, path, model, optimizer, scheduler, step, epoch, batch, config) -> None:
        os.makedirs(self.directory, exist_ok=True)
        state = {
            "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict(),
            "step": int(step), "epoch": int(epoch), "batch": int(batch),
            "config": dataclasses.asdict(config),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def _read(self, step: Optional[int], map_location="cpu") -> Dict[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location=map_location, weights_only=True)

    def restore(self, model: nn.Module, optimizer, scheduler,
                step: Optional[int] = None, map_location="cpu") -> Dict[str, Any]:
        """Load the state of ``step`` (the newest by default) into the three
        objects in place, read onto ``map_location`` (each rank of a process
        group reads it onto its own device); returns its step, epoch, batch
        and config."""
        state = self._read(step, map_location)
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
