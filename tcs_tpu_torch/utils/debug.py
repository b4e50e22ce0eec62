"""Divergence detection (the port's copy of ``tcs_tpu/utils/debug.py``
``FailureDetector``; the reference has only inline NaN asserts)."""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


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
