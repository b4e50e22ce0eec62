"""Streaming temporal evaluation loop (port of ``tcs_tpu/evaluate.py:54-138``).

:class:`TemporalEvaluator` carries the :class:`TemporalState` across the
frames of one sequence stream (or a batch of streams) on one device. Frames
are padded to /32 with the K-tracking :class:`InputPadder`.
"""

from __future__ import annotations

import numpy as np
import torch

from tcs_tpu_torch import device as device_lib
from tcs_tpu_torch.config import ModelConfig
from tcs_tpu_torch.models.tc_stereo import CameraParams, TCStereo, TemporalState
from tcs_tpu_torch.utils.padder import InputPadder


def make_eval_fn(model: TCStereo, iters: int):
    """step(image1, image2, state, cam, T) → (flow, new_state)."""

    def step(image1, image2, state, cam, T):
        out = model(image1, image2, state, cam, T, iters=iters, test_mode=True)
        return out.flow, out.new_state

    return step


class TemporalEvaluator:
    """Carries state and the step across the frames of a sequence stream."""

    def __init__(self, model: TCStereo, cfg: ModelConfig, iters: int, device=None):
        self.device = device_lib.resolve(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.iters = iters
        self._step = make_eval_fn(self.model, iters)
        self.state = None

    def reset(self):
        self.state = None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def __call__(self, image1: np.ndarray, image2: np.ndarray,
                 K: np.ndarray, baseline, T: np.ndarray) -> np.ndarray:
        """image1/2: (H, W, 3) → disparity (H, W) numpy ≥ 0; or batched
        (D, H, W, 3) with K (D,3,3), baseline (D,), T (D,4,4) → (D, H, W)."""
        batched = np.ndim(image1) == 4
        if not batched:
            image1, image2 = image1[None], image2[None]
            K, T = np.asarray(K)[None], np.asarray(T)[None]
            baseline = np.full((1,), baseline, np.float32)
        D, H, W = image1.shape[:3]
        padder = InputPadder((D, H, W, 3), divis_by=32)
        (i1, i2), Kp = padder.pad(self._tensor(image1), self._tensor(image2),
                                  K=self._tensor(K))
        cam = CameraParams(K=Kp, baseline=self._tensor(baseline).reshape(D))
        if self.state is None:
            self.state = TemporalState.zeros(D, i1.shape[1], i1.shape[2], self.cfg,
                                             device=self.device)
        flow, self.state = self._step(i1, i2, self.state, cam, self._tensor(T))
        out = (-padder.unpad(flow)[..., 0]).cpu().numpy()
        return out if batched else out[0]
