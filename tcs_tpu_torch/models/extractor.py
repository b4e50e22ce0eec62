"""Context encoder ladder and the two matching-feature networks, the head on
the shared trunk and the separate ``BasicEncoder``
(port of ``tcs_tpu/models/extractor.py``), NCHW.

Parameter names follow the reference (``core/extractor.py:195``): its heads
are named by nominal /8, /16, /32 scales although with n_downsample=2 they
run at 1/4, 1/8 and 1/16.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcs_tpu_torch.models.layers import Conv, ResidualBlock, make_norm


def _stage(ci: int, co: int, norm_fn: str, stride: int) -> nn.Sequential:
    return nn.Sequential(ResidualBlock(ci, co, norm_fn, stride),
                         ResidualBlock(co, co, norm_fn, 1))


class MultiBasicEncoder(nn.Module):
    """Trunk + (net, inp) context heads at three scales.

    ``forward(x, dual_inp=True)`` runs the trunk on the batch-stacked
    ``cat([img1, img2])`` and the heads on the first half; it returns
    ``(cnet_list, trunk)`` with cnet_list fine→coarse, each ``(net, inp)``.
    With ``dual_inp=False`` (the non-shared backbone) ``x`` is image 1 alone
    and ``trunk`` is None. Batch norms take their statistics over the batch
    the trunk runs on, both images of a pair on the shared backbone.
    """

    def __init__(self, output_dims: Sequence[Sequence[int]] = ((128,) * 3,) * 2,
                 norm_fn: str = "none"):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 1, 3)
        self.norm1 = make_norm(norm_fn, 64)
        self.layer1 = _stage(64, 64, norm_fn, 1)
        self.layer2 = _stage(64, 96, norm_fn, 2)
        self.layer3 = _stage(96, 128, norm_fn, 2)
        self.layer4 = _stage(128, 128, norm_fn, 2)
        self.layer5 = _stage(128, 128, norm_fn, 2)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, 1), Conv(128, d[2], 3, 1, 1))
            for d in output_dims)
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, 1), Conv(128, d[1], 3, 1, 1))
            for d in output_dims)
        self.outputs32 = nn.ModuleList(Conv(128, d[0], 3, 1, 1) for d in output_dims)

    def forward(self, x: torch.Tensor, dual_inp: bool = True):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        trunk = None
        if dual_inp:
            trunk = x
            x = x[: x.shape[0] // 2]
        y = self.layer4(x)
        z = self.layer5(y)
        cnet_list = (tuple(h(x) for h in self.outputs08),
                     tuple(h(y) for h in self.outputs16),
                     tuple(h(z) for h in self.outputs32))
        return cnet_list, trunk


class BasicEncoder(nn.Module):
    """Matching-feature encoder of the non-shared backbone (reference
    ``core/extractor.py:119``, ``tcs_tpu/models/extractor.py:167-186``): the
    strides follow ``downsample``. Called on the batch-stacked pair, as the
    reference calls it on a list; its instance norms are per sample."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance",
                 downsample: int = 2):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 1 + (downsample > 2), 3)
        self.norm1 = make_norm(norm_fn, 64)
        self.layer1 = _stage(64, 64, norm_fn, 1)
        self.layer2 = _stage(64, 96, norm_fn, 1 + (downsample > 1))
        self.layer3 = _stage(96, 128, norm_fn, 1 + (downsample > 0))
        self.conv2 = Conv(128, output_dim, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class SharedBackboneHead(nn.Sequential):
    """Matching head on the shared trunk (reference ``tc_stereo.py:40-43``)."""

    def __init__(self):
        super().__init__(ResidualBlock(128, 128, "instance", 1),
                         Conv(128, 256, 3, 1, 1))
