"""Metrics logging (the port's copy of ``tcs_tpu/utils/logging_utils.py``;
reference ``Logger``, ``train_stereo.py:195-246``).

Running-mean accumulation with periodic flush; backends are pluggable —
stdout/python-logging always, wandb only when available *and* explicitly
requested (the reference hardcodes a wandb entity and makes wandb a hard
dependency; here it is optional). Metrics may arrive as 0-d device tensors
and are only fetched to host at flush time (one device sync per
``sum_freq`` steps instead of the reference's per-frame ``.item()`` syncs).
Images go to disk through :mod:`tcs_tpu_torch.data.png`. Under a process
group (``parallel.mesh``) only rank 0 writes the JSONL file and logs to
wandb; every rank's metrics are the global batch's already.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np

from tcs_tpu_torch.data import png
from tcs_tpu_torch.parallel import mesh
from tcs_tpu_torch.utils.visualization import (
    _ERROR_COLS,
    disparity_panel,
    error_colormap,
    pseudo_color_map,
)

logger = logging.getLogger("tcs_tpu_torch")


class MetricsLogger:
    def __init__(self, sum_freq: int = 100, frame_length: int = 1,
                 use_wandb: bool = False, wandb_init_kwargs: Optional[dict] = None,
                 jsonl_path: Optional[str] = None):
        self.sum_freq = sum_freq * frame_length
        self.frame_length = frame_length
        self.total_steps = 0
        self.running: Dict[str, float] = {}
        self._pending = []  # device scalars, fetched lazily at flush
        primary = mesh.is_primary()
        use_wandb = use_wandb and primary
        self.jsonl_path = jsonl_path if primary else None
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_init_kwargs or {}))
                self._wandb = wandb
            except Exception as e:  # wandb unavailable/offline
                logger.warning("wandb disabled: %s", e)

    def push(self, metrics: Dict):
        """Accumulate one step's metrics (device or host scalars)."""
        self.total_steps += 1
        self._pending.append(metrics)
        if self.total_steps % self.sum_freq == self.sum_freq - 1:
            self._flush()

    def _flush(self):
        if not self._pending:
            return
        # Fetch device values now (single sync point).
        acc: Dict[str, float] = {}
        for m in self._pending:
            for k, v in m.items():
                acc[k] = acc.get(k, 0.0) + float(v)
        n = len(self._pending)
        self._pending = []
        means = {k: v / n for k, v in acc.items()}
        step = self.total_steps // self.frame_length
        rate = self.sum_freq / max(time.time() - self._t0, 1e-9)
        self._t0 = time.time()
        msg = ", ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
        logger.info("step %d (%.2f it/s): %s", step, rate, msg)
        if self._wandb is not None:
            self._wandb.log(means, step=step)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({"step": step, **means}) + "\n")

    def log_images(self, tag: str, image, disp_pred, disp_gt=None,
                   out_dir: Optional[str] = None, vmax: float = 96.0):
        """Log a qualitative disparity panel (wandb image and/or PNG on disk)."""
        panel = disparity_panel(image, disp_pred, disp_gt, vmax)
        if self._wandb is not None:
            self._wandb.log({tag: self._wandb.Image(panel)})
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            png.write_png(os.path.join(
                out_dir, f"{tag.replace('/', '_')}_{self.total_steps}.png"), panel)

    def log_feature_map(self, tag: str, features, max_channels: int = 8,
                        vmin=None, vmax=None, out_dir: Optional[str] = None):
        """Per-channel pseudo-color images of the first instance of a feature
        map (reference ``logFeatureMap``, visualization.py:98-129). Accepts
        (N, H, W, C) NHWC, (H, W, C) or (H, W); wandb-optional — a no-op
        sink when neither wandb nor ``out_dir`` is configured."""
        if self._wandb is None and not out_dir:
            return
        f = np.asarray(features, np.float32)
        if f.ndim == 4:
            f = f[0]
        if f.ndim == 2:
            f = f[..., None]
        lo = float(np.min(f)) if vmin is None else vmin
        hi = float(np.max(f)) if vmax is None else vmax
        imgs = {
            f"{tag}_{c}": pseudo_color_map(f[..., c], lo, hi,
                                           kitti_style=False)
            for c in range(min(f.shape[-1], max_channels))
        }
        self._emit_images(imgs, out_dir)

    def log_error_map(self, tag: str, disp_pred, disp_gt,
                      out_dir: Optional[str] = None):
        """KITTI-devkit colored disparity-error image with the 10-color
        legend strip (reference ``logErrorMap``, visualization.py:147-179);
        invalid (gt <= 0) pixels are black. wandb-optional."""
        if self._wandb is None and not out_dir:
            return
        pred = np.asarray(disp_pred, np.float32)
        gt = np.asarray(disp_gt, np.float32)
        img = error_colormap(pred, gt, gt > 0)
        # legend: one 20px swatch per error bucket along the top-left edge
        for i, (_, _, r, g, b) in enumerate(_ERROR_COLS):
            img[:10, i * 20:(i + 1) * 20] = (int(r), int(g), int(b))
        self._emit_images({tag: img}, out_dir)

    def _emit_images(self, images: Dict[str, np.ndarray],
                     out_dir: Optional[str]):
        if self._wandb is not None:
            self._wandb.log(
                {k: self._wandb.Image(v) for k, v in images.items()},
                commit=False,
            )
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            for k, v in images.items():
                png.write_png(os.path.join(
                    out_dir, f"{k.replace('/', '_')}_{self.total_steps}.png"), v)

    def write_dict(self, results: Dict):
        """Log evaluation results immediately."""
        logger.info("eval: %s", results)
        if self._wandb is not None:
            self._wandb.log(results)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({"step": self.total_steps, **results}) + "\n")
