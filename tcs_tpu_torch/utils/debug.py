"""Finiteness checks and divergence detection (the port's copy of
``tcs_tpu/utils/debug.py``; the reference has only inline NaN asserts).

- :func:`enable_nan_checks`: fail at the first non-finite result of any op;
- :func:`assert_finite`: raise, naming the leaf, where a tensor of a nested
  container holds a NaN or an infinity;
- :func:`check_finite_tree`: whether every floating leaf is finite;
- :class:`FailureDetector`: divergence from a training step's metrics.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Iterator, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

logger = logging.getLogger(__name__)


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested container, paths written as
    ``jax.tree_util.keystr`` writes them: ``['key']``, ``[index]``,
    ``.field``; dict keys in sorted order, as JAX flattens dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif tree is not None:
        yield path, tree


def _is_finite(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return not x.is_floating_point() or bool(torch.isfinite(x).all())
    a = np.asarray(x)
    return not np.issubdtype(a.dtype, np.floating) or bool(np.isfinite(a).all())


def assert_finite(tree: Any, name: str = "value") -> None:
    """Raise ``FloatingPointError("non-finite values in <name><path>")`` at
    the first floating leaf (tensor or array) with a NaN or an infinity."""
    for path, x in _leaves(tree):
        if not _is_finite(x):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def check_finite_tree(tree: Any) -> bool:
    """Whether every floating leaf of a nested container is finite."""
    return all(_is_finite(x) for _, x in _leaves(tree))


class _NonFiniteCheck(TorchDispatchMode):
    """Checks every floating result of every op as it comes."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for path, x in _leaves(out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(x, torch.Tensor) and not _is_finite(x):
                raise FloatingPointError(f"{func} gave non-finite values (output {path})")
        return out


_nan_checks = []  # the one active check, entered while enabled


def enable_nan_checks(enable: bool = True) -> None:
    """Fail at the first non-finite result, in this thread, from here on
    (``enable=False`` stops it): every floating tensor an op returns is
    checked, and a NaN or an infinity raises ``FloatingPointError`` naming
    the op; autograd's anomaly mode does the same for backward nodes and
    names the forward op that made the node.

    Against ``tcs_tpu``'s ``jax_debug_nans``: this also catches infinities
    (JAX needs ``jax_debug_infs`` for those), and it needs no re-run to find
    the op, as it checks every op as it runs. It does not see inside a hand
    kernel (``tcs_tpu_torch/csrc``, called through ctypes): a NaN a kernel
    writes is caught at the first op that reads it, where JAX names the
    ``pallas_call``. It checks every op, so intermediates that the model
    produces non-finite on purpose and then masks (``depth2disp`` of a zero
    depth) fail too, where JAX flags only NaNs. Each check reads the result
    on the host: a run under it is slow.
    """
    if enable and not _nan_checks:
        mode = _NonFiniteCheck()
        mode.__enter__()
        _nan_checks.append(mode)
        torch.autograd.set_detect_anomaly(True)
    elif not enable and _nan_checks:
        _nan_checks.pop().__exit__(None, None, None)
        torch.autograd.set_detect_anomaly(False)


class FailureDetector:
    """Detects training divergence from step metrics.

    ``update`` returns True while the run is healthy: False once ``patience``
    consecutive steps had a non-finite loss or gradient norm, or a gradient
    norm at or above ``grad_norm_limit``. The caller decides what follows.
    """

    def __init__(self, patience: int = 1, grad_norm_limit: float = 1e4):
        self.patience = patience
        self.grad_norm_limit = grad_norm_limit
        self.consecutive_bad = 0
        self.total_bad = 0

    def update(self, metrics: dict) -> bool:
        loss = float(metrics.get("live_loss", 0.0))
        gnorm = float(metrics.get("grad_norm", 0.0))
        healthy = np.isfinite(loss) and np.isfinite(gnorm) and (
            gnorm < self.grad_norm_limit
        )
        if healthy:
            self.consecutive_bad = 0
        else:
            self.consecutive_bad += 1
            self.total_bad += 1
            logger.warning(
                "unhealthy step: loss=%s grad_norm=%s (%d consecutive)",
                loss, gnorm, self.consecutive_bad,
            )
        return self.consecutive_bad < self.patience
