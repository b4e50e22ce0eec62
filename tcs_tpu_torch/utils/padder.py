"""Input padding with intrinsics tracking (port of ``tcs_tpu/utils/padder.py``).

Pads NHWC images so that H and W are divisible by ``divis_by`` (replicate
padding) and shifts K's principal point by the left/top pad; ``unpad``
reverses both. The pad splits symmetrically (the reference's 'sintel' mode,
the one its evaluators use).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


class InputPadder:
    """Pads images such that dimensions are divisible by ``divis_by``."""

    def __init__(self, dims: Tuple[int, ...], divis_by: int = 32):
        self.ht, self.wd = int(dims[-3]), int(dims[-2])  # NHWC
        pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
        pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                     pad_ht // 2, pad_ht - pad_ht // 2]

    def _k_shift(self, K: torch.Tensor) -> torch.Tensor:
        shift = torch.zeros(3, 3, dtype=K.dtype, device=K.device)
        shift[0, 2] = self._pad[0]
        shift[1, 2] = self._pad[2]
        return shift

    def pad(self, *inputs, K: Optional[torch.Tensor] = None):
        """inputs: NHWC tensors. Returns the padded list (and the shifted K)."""
        outs = [F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate")
                .permute(0, 2, 3, 1) for x in inputs]
        if K is not None:
            return outs, K + self._k_shift(K)
        return outs

    def unpad(self, x: torch.Tensor, K: Optional[torch.Tensor] = None):
        ht, wd = x.shape[-3], x.shape[-2]
        c = [self._pad[2], ht - self._pad[3], self._pad[0], wd - self._pad[1]]
        out = x[..., c[0]:c[1], c[2]:c[3], :]
        if K is not None:
            return out, K - self._k_shift(K)
        return out
