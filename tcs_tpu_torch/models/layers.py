"""Basic blocks (port of ``tcs_tpu/models/layers.py``), NCHW.

Mixed precision follows the JAX package with explicit casts, not autocast:
parameters stay fp32 and every convolution casts its input, weight and bias
to the module's ``compute_dtype`` (bf16 under ``mixed_precision``), as a Flax
``nn.Conv(dtype=...)`` does. Every norm takes its statistics in fp32.

Module and parameter names follow the reference torch model, so its state
dicts load with ``strict=True``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcs_tpu_torch.config import CONTEXT_NORMS
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


class GroupNorm(nn.Module):
    """torch ``GroupNorm`` with C/8 groups, eps 1e-5, affine; statistics in
    fp32 (``tcs_tpu.models.layers.GroupNorm``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.num_groups = channels // 8
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            1e-5).to(x.dtype)


class BatchNorm(nn.Module):
    """Batch normalisation from the statistics of the current batch, always,
    with affine parameters and no running buffers
    (``tcs_tpu.models.layers.BatchNorm``, ``layers.py:73-98``).

    ``nn.BatchNorm2d`` would read running averages in ``eval()``, which
    ``tcs_tpu`` never does, so test mode would compute another function.
    Statistics in fp32, biased variance, eps 1e-5.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.batch_norm(x.float(), None, None, self.weight, self.bias,
                            training=True, momentum=0.0, eps=1e-5).to(x.dtype)


def make_norm(norm_fn: str, channels: int) -> nn.Module:
    """The reference's ``norm_fn`` dispatch (``tcs_tpu.models.layers.Norm``).
    ``'none'`` is ``nn.Identity``: no parameters and no launch."""
    if norm_fn == "none":
        return nn.Identity()
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "group":
        return GroupNorm(channels)
    if norm_fn == "batch":
        return BatchNorm(channels)
    raise ValueError(f"unknown norm_fn {norm_fn!r}: one of {CONTEXT_NORMS}")


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
    """Two 3×3 convs + norm + residual (reference ``core/extractor.py:5``).

    ``norm3`` sits on the downsample branch, registered under both names as
    in the reference (``norm3`` and ``downsample.1``), so a reference state
    dict loads as it is.
    """

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "none",
                 stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride, 1)
        self.conv2 = Conv(planes, planes, 3, 1, 1)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if not (stride == 1 and in_planes == planes):
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(Conv(in_planes, planes, 1, stride, 0),
                                            self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
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
