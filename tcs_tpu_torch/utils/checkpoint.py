"""Checkpoints: weights in the reference's ``.pth`` format, in
``tcs_tpu``'s ``.npz`` format and in ``tcs_tpu``'s Orbax format; the
trainer's full-state checkpoints, whose weights are in the ``.pth`` format
too; and ``tcs_tpu``'s full training state in its Orbax format.

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

``tcs_tpu``'s Orbax checkpoints (``tcs_tpu/utils/checkpoint.py:19-95``) are
read and written through :mod:`tcs_tpu_torch.utils.orbax_format`, without
Orbax: :func:`load_params` / :func:`save_params` are ``tcs_tpu``'s
params-only export (``save_params`` / ``load_params`` there), at fp32;
:func:`restore_tcs_tpu` / :func:`save_tcs_tpu` its ``CheckpointManager``'s
full ``TrainState`` (params, AdamW's moments and count, the schedule's count,
the step). :func:`load_any` takes whatever ``--restore_ckpt`` may name.
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
from tcs_tpu_torch.utils import orbax_format

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


def load_params_npz(model: nn.Module, path) -> nn.Module:
    """Load ``tcs_tpu``'s ``.npz`` parameter file into ``model`` in place
    (each array as float32); returns ``model``. Raises ``KeyError`` naming
    the file's keys if it holds a parameter the model lacks or lacks one the
    model has."""
    own = convert.params_from_state_dict(model.state_dict(), model.cfg.context_norm)
    want = {_keystr(p) for p, _ in orbax_format.flatten(own)}
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
    np.savez_compressed(path, **{_keystr(p): v.astype(dtype)
                                 for p, v in orbax_format.flatten(tree)})


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
        (``--restore_ckpt`` on a directory of checkpoints). A directory with
        none of the port's checkpoints but ``tcs_tpu``'s Orbax steps gives
        its newest step's params, as ``tcs_tpu``'s ``restore_params_only``
        does."""
        if step is None and self.latest_step() is None:
            steps = orbax_format.step_dirs(self.directory)
            if steps:
                return load_params(model, steps[max(steps)])
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return load_weights(model, self.path(step))


# ------------------------------------------------- tcs_tpu's Orbax checkpoints

def _tree_to_state_dict(model: nn.Module, tree, where) -> Dict[str, torch.Tensor]:
    """A ``{"params": tree}`` of tensors (parameters or one of AdamW's
    moments, in ``tcs_tpu``'s layout) → the port's state dict, fp32; raises
    ``KeyError`` listing the leaves that do not fit the model."""
    own = convert.params_from_state_dict(model.state_dict(), model.cfg.context_norm)
    want = {p for p, _ in orbax_format.flatten(own)}
    flat = orbax_format.flatten(tree)
    got = {p for p, _ in flat}
    missing, unexpected = sorted(want - got), sorted(got - want)
    if missing or unexpected:
        raise KeyError(f"{where} does not fit the model: missing {missing[:5]},"
                       f" unexpected {unexpected[:5]}")
    nested: dict = {}
    for path, t in flat:
        node = nested
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.to(torch.float32).numpy()
    return convert.state_dict_from_jax(nested, model.cfg.n_gru_layers)


def _read_params(path) -> dict:
    """``{"params": tree}`` of a ``save_params`` export or of a
    ``TrainState`` step (whose params sit one level deeper)."""
    tree = orbax_format.read_tree(path, ("params",))["params"]
    if set(tree) == {"params"}:  # a TrainState's ('params', 'params', ...)
        tree = tree["params"]
    return {"params": tree}


def load_params(model: nn.Module, directory) -> nn.Module:
    """Load ``tcs_tpu``'s ``save_params`` export (or the params of one
    ``CheckpointManager`` step directory) into ``model`` in place, as fp32;
    returns ``model``. Strict: a leaf too many or too few raises
    ``KeyError``."""
    sd = _tree_to_state_dict(model, _read_params(directory), directory)
    model.load_state_dict(sd, strict=True)
    logger.info("loaded %d tensors from tcs_tpu's Orbax checkpoint %s", len(sd), directory)
    return model


def save_params(model: nn.Module, directory) -> None:
    """``model``'s weights as ``tcs_tpu``'s ``save_params`` export, fp32:
    ``tcs_tpu``'s ``load_params`` reads it into a tree of the same
    architecture."""
    orbax_format.save_tree(directory, convert.params_from_state_dict(
        model.state_dict(), model.cfg.context_norm))


def _moment_states(model: nn.Module, optimizer):
    """AdamW's step and the two moments of every named state-dict entry
    (a tied parameter under each of its names), zeros where the optimiser
    has taken no step."""
    params = dict(model.named_parameters(remove_duplicate=False))
    steps, mu, nu = set(), {}, {}
    for name, t in model.state_dict().items():
        p = params.get(name)
        if p is None:
            raise KeyError(f"state dict entry {name} is not a parameter of the model")
        st = optimizer.state.get(p, {})
        if "exp_avg" in st:
            steps.add(float(st["step"]))
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        else:
            steps.add(0.0)
            mu[name] = nu[name] = torch.zeros_like(t)
    if len(steps) != 1:
        raise ValueError(f"AdamW's parameters are at different steps: {sorted(steps)}")
    return int(steps.pop()), mu, nu


def save_tcs_tpu(directory, step: int, model: nn.Module, optimizer, scheduler) -> str:
    """The port's training state as step ``step`` of ``tcs_tpu``'s Orbax
    ``CheckpointManager`` directory ``directory``: a ``TrainState`` of
    ``tcs_tpu.train.optim.make_optimizer``'s chain (clip, AdamW with its
    schedule), which ``tcs_tpu``'s ``CheckpointManager.restore`` restores and
    trains on from. Returns the step directory. Under a process group rank 0
    writes, and every rank waits for it."""
    count, mu, nu = _moment_states(model, optimizer)
    if scheduler.last_epoch != count:
        raise ValueError(f"the schedule is at step {scheduler.last_epoch}, AdamW at {count}")
    norm = model.cfg.context_norm
    tree = {"step": int(step),
            "params": convert.params_from_state_dict(model.state_dict(), norm),
            "opt_state": (None, ({"count": torch.tensor(count, dtype=torch.int32),
                                  "mu": convert.params_from_state_dict(mu, norm),
                                  "nu": convert.params_from_state_dict(nu, norm)},
                                 None, {"count": torch.tensor(count, dtype=torch.int32)}))}
    path = os.path.join(os.path.abspath(directory), str(int(step)))
    if mesh.is_primary():
        orbax_format.save_step(directory, step, tree)
    mesh.barrier()
    return path


def restore_tcs_tpu(directory, model: nn.Module, optimizer, scheduler,
                    step: Optional[int] = None) -> int:
    """Load step ``step`` (the newest by default) of ``tcs_tpu``'s Orbax
    ``CheckpointManager`` directory into the port in place: the params into
    ``model``; AdamW's ``mu`` and ``nu`` into each parameter's ``exp_avg``
    and ``exp_avg_sq``, through the same layout change as the parameter;
    its ``count`` into AdamW's ``step`` and the schedule's ``last_epoch``
    (the learning rate follows). Both packages bias-correct with the count
    after its increment, and both run update k at ``schedule(k)``. Each
    tensor goes to its parameter's device. Returns the step. Raises where
    the schedule's count is not AdamW's, or the tree is not
    ``make_optimizer``'s."""
    steps = orbax_format.step_dirs(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no tcs_tpu checkpoint in {directory}")
        step = max(steps)
    if step not in steps:
        raise FileNotFoundError(f"no step {step} in {directory}: steps {sorted(steps)}")
    where = steps[step]
    tree = orbax_format.read_tree(where)
    try:
        adam, sched = tree["opt_state"]["1"]["0"], tree["opt_state"]["1"]["2"]
        count, sched_count = int(adam["count"]), int(sched["count"])
        mu, nu = adam["mu"], adam["nu"]
    except (KeyError, TypeError) as e:
        raise KeyError(f"{where}: not a TrainState of tcs_tpu's make_optimizer chain "
                       f"(clip, AdamW, schedule): {e!r}") from e
    if count != sched_count:
        raise ValueError(f"{where}: the schedule's count {sched_count} is not AdamW's {count}")
    model.load_state_dict(_tree_to_state_dict(model, tree["params"], where), strict=True)
    exp_avg = _tree_to_state_dict(model, mu, f"{where} (mu)")
    exp_avg_sq = _tree_to_state_dict(model, nu, f"{where} (nu)")
    params = dict(model.named_parameters())
    groups = {id(p): g for g in optimizer.param_groups for p in g["params"]}
    for name, p in params.items():
        g = groups[id(p)]
        on_device = g.get("fused") or g.get("capturable")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": exp_avg[name].to(p.device, p.dtype),
            "exp_avg_sq": exp_avg_sq[name].to(p.device, p.dtype)}
    scheduler.last_epoch = count
    lrs = [base * f(count) for base, f in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for g, lr in zip(optimizer.param_groups, lrs):
        g["lr"] = lr
    scheduler._last_lr = lrs
    logger.info("restored tcs_tpu's training state at step %d (AdamW count %d) from %s",
                int(tree["step"]), count, where)
    return int(tree["step"])


def load_any(model: nn.Module, path) -> nn.Module:
    """Weights from whatever ``--restore_ckpt`` names: a ``.pth`` file (the
    reference's format), ``tcs_tpu``'s ``.npz``, ``tcs_tpu``'s ``save_params``
    export directory, a directory of the port's full checkpoints, or
    ``tcs_tpu``'s ``CheckpointManager`` directory (its newest step's
    params)."""
    if os.path.isdir(path):
        if orbax_format.is_orbax_dir(path):
            return load_params(model, path)
        return CheckpointManager(path).restore_params_only(model)
    if str(path).endswith(".npz"):
        return load_params_npz(model, path)
    return load_weights(model, path)
