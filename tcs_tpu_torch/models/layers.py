"""Basic blocks (port of ``tcs_tpu/models/layers.py``), NCHW.

Mixed precision follows the JAX package with explicit casts, not autocast:
parameters stay fp32 and every convolution casts its input, weight and bias
to the module's ``compute_dtype`` (bf16 under ``mixed_precision``), as a Flax
``nn.Conv(dtype=...)`` does. Instance norm takes its statistics in fp32.

Module and parameter names follow the reference torch model, so its state
dicts load with ``strict=True``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcs_tpu_torch.ops.sampler import resize_nearest_nchw


class Conv(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype``."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in ``compute_dtype``."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            m.compute_dtype = dtype


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``InstanceNorm2d`` defaults: per-(sample, channel) stats, no affine."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class InstanceNorm(nn.Module):
    """:func:`instance_norm` as a module, for ``nn.Sequential`` ladders."""

    def forward(self, x):
        return instance_norm(x)


def conv_seq(specs, final_relu: bool = False) -> nn.Sequential:
    """conv → relu → conv ladder, laid out as the reference's ``nn.Sequential``
    (a conv at every even index). specs: (in, out, kernel, stride, padding)."""
    layers = []
    for i, (ci, co, k, s, p) in enumerate(specs):
        layers.append(Conv(ci, co, k, s, p))
        if i < len(specs) - 1 or final_relu:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class ResidualBlock(nn.Module):
    """Two 3×3 convs + residual (reference ``core/extractor.py:5``).

    ``norm_fn`` is 'none' or 'instance'; neither has parameters.
    """

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "none",
                 stride: int = 1):
        super().__init__()
        if norm_fn not in ("none", "instance"):
            raise NotImplementedError(f"norm_fn={norm_fn!r} is not ported")
        self.norm_fn = norm_fn
        self.conv1 = Conv(in_planes, planes, 3, stride, 1)
        self.conv2 = Conv(planes, planes, 3, 1, 1)
        self.downsample = None
        if not (stride == 1 and in_planes == planes):
            self.downsample = nn.Sequential(Conv(in_planes, planes, 1, stride, 0))

    def _norm(self, x):
        return instance_norm(x) if self.norm_fn == "instance" else x

    def forward(self, x):
        y = F.relu(self._norm(self.conv1(x)))
        y = F.relu(self._norm(self.conv2(y)))
        if self.downsample is not None:
            x = self._norm(self.downsample(x))
        return F.relu(x.to(y.dtype) + y)


class BasicConvIN(nn.Module):
    """Conv (or deconv) + optional InstanceNorm + LeakyReLU, no bias
    (reference ``core/utils/basic_layers.py:9``)."""

    def __init__(self, ci: int, co: int, deconv: bool = False, use_in: bool = True,
                 kernel: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        cls = ConvTranspose if deconv else Conv
        self.conv = cls(ci, co, kernel, stride, padding, bias=False)
        self.use_in = use_in

    def forward(self, x):
        x = self.conv(x)
        if self.use_in:
            x = instance_norm(x)
        return F.leaky_relu(x, 0.01)


class Conv2xIN(nn.Module):
    """Deconv-upsample, add the skip, conv (reference ``basic_layers.py:38``,
    deconv=True, concat=False)."""

    def __init__(self, ci: int, co: int, use_in: bool = True):
        super().__init__()
        self.conv1 = BasicConvIN(ci, co, deconv=True, use_in=True, kernel=4,
                                 stride=2, padding=1)
        self.conv2 = BasicConvIN(co, co, deconv=False, use_in=use_in)

    def forward(self, x, rem):
        x = self.conv1(x)
        if x.shape[2:] != rem.shape[2:]:
            x = resize_nearest_nchw(x, rem.shape[2:])
        return self.conv2(x + rem.to(x.dtype))
