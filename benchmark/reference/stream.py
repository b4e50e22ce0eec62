"""Streaming inference of the reference: a batch of synchronised streams,
the state carried from frame to frame and reset at a scene's first frame,
each frame padded to /32 with its intrinsics shifted and the disparity
cropped back (the semantics of ``tcs_tpu_torch.evaluate.TemporalEvaluator``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ops
from benchmark.reference.model import State, TCStereo


class Stream:
    """``__call__(image1, image2, K, baseline, T)`` on (D,H,W,3) frames (any
    numeric dtype, values in [0, 255]), K (D,3,3), baseline (D,), T (D,4,4)
    → disparity (D,H,W) as a float32 tensor on the model's device."""

    def __init__(self, model: TCStereo, iters: int, device):
        self.model, self.iters, self.device = model, iters, torch.device(device)
        self.state = None

    def reset(self):
        self.state = None

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def __call__(self, image1, image2, K, baseline, T) -> torch.Tensor:
        D, H, W = image1.shape[:3]
        padder = ops.InputPadder((D, H, W, 3), divis_by=32)
        (i1, i2), Kp = padder.pad(self._t(image1), self._t(image2), K=self._t(K))
        if self.state is None:
            self.state = State.zeros(D, i1.shape[1], i1.shape[2], self.model.arch, self.device)
        out = self.model(i1, i2, self.state, Kp, self._t(baseline).reshape(D), self._t(T),
                         self.iters)
        self.state = out.state
        return -padder.unpad(out.flow)[..., 0]
