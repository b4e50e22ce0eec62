"""GRU update stack, temporal completion and dual-space refinement heads
(port of ``tcs_tpu/models/update.py``).

Conv features are NCHW. The 1- and 2-channel disparity fields and their
arithmetic stay NHWC and fp32, in the JAX package's layout, so that the
geometry helpers are shared with it one to one; a (B, h, w, 1) map permutes
to (B, 1, h, w) without a copy.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcs_tpu_torch.geometry import disp2disp_grad_candidates
from tcs_tpu_torch.models.layers import (
    Conv,
    Conv2xIN,
    InstanceNorm,
    LeakyReLU,
    conv_seq,
    sigmoid,
)
from tcs_tpu_torch.ops.sampler import pool2x_nchw, resize_bilinear_nchw
from tcs_tpu_torch.ops.sampler import to_nchw as _c
from tcs_tpu_torch.ops.sampler import to_nhwc as _h


class ConvINConv(nn.Sequential):
    """conv(stride) → InstanceNorm → ReLU → conv (reference update.py:325-344)."""

    def __init__(self, ci: int, mid: int, out: int, stride: int = 1):
        super().__init__(Conv(ci, mid, 3, stride, 1), InstanceNorm(), nn.ReLU(),
                         Conv(mid, out, 3, 1, 1))


class FlowHead(nn.Module):
    """conv3x3 → relu → conv3x3, output fp32 (reference :9)."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256,
                 output_dim: int = 1):
        super().__init__()
        self.conv1 = Conv(input_dim, hidden_dim, 3, 1, 1)
        self.conv2 = Conv(hidden_dim, output_dim, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x))).float()


class _GatedFuse(nn.Module):
    """h ← z·h + (1−z)·q with 1×1 gates on cat(h, x)."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        self.convzr = Conv(hidden_dim + input_dim, 2 * hidden_dim, 1, 1, 0)
        self.convq = Conv(hidden_dim + input_dim, hidden_dim, 1, 1, 0)

    def fuse(self, h, x):
        z, r = torch.chunk(self.convzr(torch.cat([h, x], dim=1)), 2, dim=1)
        z, r = sigmoid(z), sigmoid(r)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return z * h + (1 - z) * q


class LightFuse(_GatedFuse):
    """Gated fusion of the current and the pose-warped hidden state (reference :20)."""

    def __init__(self, hidden_dim: int):
        super().__init__(hidden_dim, hidden_dim)

    def forward(self, h, x):
        return self.fuse(h, x.to(h.dtype))


class HiddenstateUpdater(_GatedFuse):
    """Update the finest hidden state from Δdisp (reference :48)."""

    def __init__(self, hidden_dim: int):
        super().__init__(hidden_dim, 64)
        self.convs = nn.Sequential(Conv(1, 64, 1, 1, 0), LeakyReLU(), Conv(64, 64, 1, 1, 0))

    def forward(self, h, delta_disp):
        """h: (B,C,h,w); delta_disp: (B,h,w,1) NHWC."""
        return self.fuse(h, self.convs(_c(delta_disp)))


class ConvGRU(nn.Module):
    """ConvGRU with injected context gates (reference :71):
    h ← (1−z)·h + z·q, z = σ(conv_z(h, x) + cz), r, q likewise."""

    def __init__(self, hidden_dim: int, input_dim: int, kernel: int = 3):
        super().__init__()
        self.convzr = Conv(hidden_dim + input_dim, 2 * hidden_dim, kernel, 1, kernel // 2)
        self.convq = Conv(hidden_dim + input_dim, hidden_dim, kernel, 1, kernel // 2)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=1)
        z, r = torch.chunk(self.convzr(torch.cat([h, x], dim=1)), 2, dim=1)
        z = sigmoid(z + cz)
        r = sigmoid(r + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """Encode (flow, corr lookup) into 128 motion channels (reference :90)."""

    def __init__(self, corr_planes: int = 36):
        super().__init__()
        self.convc1 = Conv(corr_planes, 64, 1, 1, 0)
        self.convc2 = Conv(64, 64, 3, 1, 1)
        self.convf1 = Conv(1, 64, 7, 1, 3)
        self.convf2 = Conv(64, 64, 3, 1, 1)
        self.conv = Conv(128, 127, 3, 1, 1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


class BasicMultiUpdateBlock(nn.Module):
    """3-level ConvGRU cascade (reference :127); net[0] is the finest scale.

    Reference names: gru08/16/32 run at 1/4, 1/8 and 1/16 with n_downsample=2.
    """

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128),
                 corr_planes: int = 36):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru08 = ConvGRU(hidden_dims[2], 128 + hidden_dims[1])
        self.gru16 = ConvGRU(hidden_dims[1], hidden_dims[0] + hidden_dims[2])
        self.gru32 = ConvGRU(hidden_dims[0], hidden_dims[1])
        self.flow_head = FlowHead(hidden_dims[2], 256, 1)

    def forward(self, net, inp, corr=None, flow=None, dtype=None, iter_fine=True,
                iter_mid=True, iter_coarse=True, update=True):
        """net/inp: NCHW per scale; corr (B,L·(2r+1),h,w); flow (B,1,h,w).

        ``iter_fine=False`` skips the motion encoder and the fine GRU (corr,
        flow and dtype are then unused); ``update=False`` returns ``net``
        alone, without the flow head (the slow-fast pre-passes,
        ``tcs_tpu/models/update.py:201-225``).
        """
        net = list(net)
        if iter_coarse:
            net[2] = self.gru32(net[2], *inp[2], pool2x_nchw(net[1]))
        if iter_mid:
            net[1] = self.gru16(net[1], *inp[1], pool2x_nchw(net[0]),
                                resize_bilinear_nchw(net[2], net[1].shape[2:]))
        if iter_fine:
            motion = self.encoder(flow.to(dtype), corr.to(dtype))
            net[0] = self.gru08(net[0], *inp[0], motion,
                                resize_bilinear_nchw(net[1], net[0].shape[2:]))
        if not update:
            return tuple(net)
        return tuple(net), self.flow_head(net[0])


class DispGradPredictor(nn.Module):
    """Gradient-space refinement (reference :171): refines the raw disparity
    gradient from 16 plane-gradient candidates with a 3-scale
    encoder-decoder fused with gradient-context features."""

    def __init__(self):
        super().__init__()
        self.conv_grad_stem = conv_seq(((2, 32, 3, 1, 1), (32, 32, 3, 1, 1)))
        self.conv_grad_candidate_stem = conv_seq(((32, 64, 3, 1, 1), (64, 64, 3, 1, 1)))
        self.conv_4_4 = conv_seq(((160, 64, 3, 1, 1),), final_relu=True)
        self.conv_4_8 = conv_seq(((64, 96, 3, 2, 1),), final_relu=True)
        self.conv_8_8 = conv_seq(((160, 96, 3, 1, 1),), final_relu=True)
        self.conv_8_16 = conv_seq(((96, 128, 3, 2, 1),), final_relu=True)
        self.conv_16_16 = conv_seq(((192, 128, 3, 1, 1),), final_relu=True)
        self.conv_16_8 = Conv2xIN(128, 96, use_in=False)
        self.conv_8_4 = Conv2xIN(96, 64, use_in=False)
        self.residual_head = conv_seq(((64, 128, 3, 1, 1), (128, 2, 3, 1, 1)))
        self.conv_out = conv_seq(((64, 64, 3, 1, 1),), final_relu=True)

    def forward(self, disp_grad, disp, clist):
        """disp_grad (B,h,w,2), disp (B,h,w,1) NHWC fp32; clist NCHW.
        Returns (refined gradient (B,h,w,2) fp32, context NCHW).

        Both inputs are constants for autograd, as in the JAX model: the
        gradient loss trains this module through its residual only."""
        disp_grad = 5.0 * disp_grad.detach()
        disp = disp.detach()
        B, H, W, _ = disp.shape
        # Reference channel order: component slowest, then the 16 directions.
        cands = disp2disp_grad_candidates(disp, level=2).permute(0, 4, 3, 1, 2)
        x4_grad = self.conv_grad_stem(_c(disp_grad))
        x4_cand = self.conv_grad_candidate_stem(cands.reshape(B, 32, H, W))
        x4 = self.conv_4_4(torch.cat([x4_grad, x4_cand, clist[0]], dim=1))
        x8 = self.conv_4_8(x4)
        x8 = self.conv_8_8(torch.cat([x8, clist[1]], dim=1))
        x16 = self.conv_8_16(x8)
        x16 = self.conv_16_16(torch.cat([x16, clist[2]], dim=1))
        x4_up = self.conv_8_4(self.conv_16_8(x16, x8), x4)
        residual = _h(self.residual_head(x4_up)).float()
        return (disp_grad + residual) / 5.0, self.conv_out(x4_up)


class UpsampleMaskHead(nn.Sequential):
    """Convex-upsample mask logits ×0.25 from the refiner's fused features
    (reference ``DispRefine.mask``, :254-257). Run on the last iteration only."""

    def __init__(self, downsample_factor: int = 4):
        super().__init__(*conv_seq(((128, 256, 3, 1, 1),
                                    (256, 9 * downsample_factor ** 2, 1, 1, 0))))

    def forward(self, fused):
        return 0.25 * super().forward(fused).float()


def propagate_disparity(disp_grad: torch.Tensor, disp: torch.Tensor):
    """Planar extrapolation from the 3×3 neighbourhood (reference :259-289).

    disp_grad (B,H,W,2), disp (B,H,W,1), fp32 NHWC → (candidates (B,H,W,9),
    |gradient differences| (B,H,W,18): all gx diffs, then all gy diffs).
    Candidate k = 3v+u is d_n + gx_n·(1−u) + gy_n·(1−v); the disparity is
    edge-padded and the gradients zero-padded. The gradient differences are
    gradient-free, as in the JAX model.
    """
    B, H, W, _ = disp.shape
    gpad = F.pad(disp_grad, (0, 0, 1, 1, 1, 1))
    dpad = _h(F.pad(_c(disp), (1, 1, 1, 1), mode="replicate"))
    cands, gdx, gdy = [], [], []
    for v in range(3):
        for u in range(3):
            d_n = dpad[:, v:v + H, u:u + W, 0]
            gx_n = gpad[:, v:v + H, u:u + W, 0]
            gy_n = gpad[:, v:v + H, u:u + W, 1]
            cands.append(d_n + gx_n * (1.0 - u) + gy_n * (1.0 - v))
            gdx.append((disp_grad[..., 0] - gx_n).abs())
            gdy.append((disp_grad[..., 1] - gy_n).abs())
    return torch.stack(cands, dim=-1), torch.stack(gdx + gdy, dim=-1).detach()


class DispRefine(nn.Module):
    """Gradient-guided propagation over 9 planar candidates (reference :217)."""

    def __init__(self, hidden_dim: int = 128, downsample_factor: int = 4):
        super().__init__()
        self.context_compress = conv_seq(((hidden_dim + 64, 96, 3, 1, 1),
                                          (96, 96, 3, 1, 1)))
        self.disp_f_stem = conv_seq(((27, 96, 1, 1, 0), (96, 96, 1, 1, 0)))
        self.conv_fuse = conv_seq(((192, 128, 3, 1, 1), (128, 128, 3, 1, 1)),
                                  final_relu=True)
        self.w_head = conv_seq(((128, 128, 3, 1, 1), (128, 9, 1, 1, 0)))
        self.mask = UpsampleMaskHead(downsample_factor)

    def forward(self, disp_grads, disp, context_disp, context_grad):
        """disp_grads (B,h,w,2), disp (B,h,w,1) NHWC fp32; contexts NCHW.
        Returns (refined disparity (B,h,w,1) fp32, fused features NCHW).

        As in the JAX model the incoming disparity is a constant for autograd
        and the candidates feed the stem detached, so the refined disparity
        reaches the gradients through the candidates' planes and the softmax
        weights only."""
        context = self.context_compress(torch.cat([context_disp, context_grad], dim=1))
        candidates, matrix = propagate_disparity(disp_grads.float(),
                                                 disp.detach().float())
        disp_f = self.disp_f_stem(_c(torch.cat([candidates.detach(), matrix], dim=-1)))
        fused = self.conv_fuse(torch.cat([disp_f, context], dim=1))
        w = torch.softmax(_h(self.w_head(fused)).float(), dim=-1)
        return torch.sum(w * candidates, dim=-1, keepdim=True), fused


class DisparityCompletor(nn.Module):
    """Temporal disparity completion (TDC, reference :308).

    Embeds (sparse disp/10, cost, mask − 0.5), runs a 3-scale
    encoder-decoder fused with context and returns the completed disparity
    (w·sparse + (1−w)·mono)·10, the mono disparity ·10, the fusion weight w
    (all (B,h,w,1) NHWC fp32) and per-scale candidate hidden states (NCHW).
    """

    def __init__(self, context_dims: Sequence[int] = (128, 128, 128)):
        super().__init__()
        c = context_dims
        self.conv_disp_stem = conv_seq(((1, 64, 1, 1, 0), (64, 64, 1, 1, 0)))
        self.conv_cost_stem = conv_seq(((1, 32, 1, 1, 0), (32, 32, 1, 1, 0)))
        self.conv_mask_stem = conv_seq(((1, 32, 1, 1, 0), (32, 32, 1, 1, 0)))
        self.conv_disp_fuse = conv_seq(((128, 128, 1, 1, 0), (128, 64, 1, 1, 0)))
        self.conv_4_4 = ConvINConv(64 + c[0], 192, 64)
        self.conv_4_8 = ConvINConv(64, 64, 64, stride=2)
        self.conv_8_8 = ConvINConv(64 + c[1], 192, 64)
        self.conv_8_16 = ConvINConv(64, 64, 64, stride=2)
        self.conv_16_16 = ConvINConv(64 + c[2], 192, 64)
        self.conv_16_8 = Conv2xIN(64, 64, use_in=True)
        self.conv_8_4 = Conv2xIN(64, 64, use_in=True)
        self.disp_head = conv_seq(((64, 128, 3, 1, 1), (128, 1, 3, 1, 1)))
        self.w_head = conv_seq(((64, 128, 3, 1, 1), (128, 1, 3, 1, 1)))
        self.conv_out4_disp = ConvINConv(64 + c[0], 192, 128)
        self.conv_out8_disp = ConvINConv(64 + c[1], 192, 128)
        self.conv_out16_disp = ConvINConv(64 + c[2], 192, 128)

    def forward(self, disp, cost, mask, context_list):
        disp = disp / 10.0
        x4_disp = self.conv_disp_fuse(torch.cat([
            self.conv_disp_stem(_c(disp)), self.conv_cost_stem(_c(cost)),
            self.conv_mask_stem(_c(mask - 0.5))], dim=1))
        x4 = self.conv_4_4(torch.cat([x4_disp, context_list[0]], dim=1))
        x8 = self.conv_8_8(torch.cat([self.conv_4_8(x4), context_list[1]], dim=1))
        x16 = self.conv_16_16(torch.cat([self.conv_8_16(x8), context_list[2]], dim=1))
        x8_out = self.conv_16_8(x16, x8)
        x4_out = self.conv_8_4(x8_out, x4)
        disp_mono = _h(self.disp_head(x4_out)).float()
        w = torch.sigmoid(_h(self.w_head(x4_out)).float())
        disp_completed = (w * disp + (1 - w) * disp_mono) * 10.0
        nets = (self.conv_out4_disp(torch.cat([x4_out, context_list[0]], dim=1)),
                self.conv_out8_disp(torch.cat([x8_out, context_list[1]], dim=1)),
                self.conv_out16_disp(torch.cat([x16, context_list[2]], dim=1)))
        return disp_completed, disp_mono * 10.0, w, nets
