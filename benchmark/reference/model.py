"""The reference TC-Stereo network in plain fp32 PyTorch.

A frozen copy of the function that ``tcs_tpu_torch/models`` computes
(encoders, cost volume and pyramid, argmax bootstrap or pose warp,
disparity completion, hidden-state warp and fusion, GRU / dual-space
refinement with one radius lookup an iteration, convex upsampling), for the
architecture the benchmark's configurations state: shared backbone, no
context norm, no slow-fast GRU. Every operation is fp32; the program's bf16
roundings (late conv bias, bf16 sigmoid and leaky slope) are not copied,
since the reference is the fp32 function. Module and parameter names are
the program's, so one state dict loads into both.

``Arch`` is read from a configuration file's ``model`` object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import geometry, ops, precision
from benchmark.reference.ops import to_nchw as _c
from benchmark.reference.ops import to_nhwc as _h


@dataclasses.dataclass(frozen=True)
class Arch:
    hidden_dims: Tuple[int, ...] = (128, 128, 128)
    context_dims: Tuple[int, ...] = (128, 128, 128)
    corr_levels: int = 4
    corr_radius: int = 4
    n_downsample: int = 2
    n_gru_layers: int = 3
    context_norm: str = "none"
    shared_backbone: bool = True
    slow_fast_gru: bool = False
    init_thres: float = 0.5
    argmax_margin: float = 0.3
    argmax_suppress_radius: float = 1.5

    def __post_init__(self):
        if (self.context_norm, self.shared_backbone, self.slow_fast_gru,
                self.n_gru_layers) != ("none", True, False, 3):
            raise ValueError("the reference holds the shared-backbone, no-norm, "
                             "three-GRU architecture only")

    @staticmethod
    def from_config(model: dict) -> "Arch":
        fields = {f.name for f in dataclasses.fields(Arch)}
        kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in model.items() if k in fields}
        return Arch(**kw)

    @property
    def factor(self) -> int:
        return 2 ** self.n_downsample

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1)


# --- blocks ------------------------------------------------------------------

class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose input, weight and output are kept as ``mode`` says."""

    mode = "fp32"

    def forward(self, x):
        q = precision.round_operand
        return q(F.conv2d(q(x.float(), self.mode), q(self.weight, self.mode), self.bias,
                          self.stride, self.padding, self.dilation, self.groups), self.mode)


class ConvTranspose(nn.ConvTranspose2d):
    mode = "fp32"

    def forward(self, x):
        q = precision.round_operand
        return q(F.conv_transpose2d(q(x.float(), self.mode), q(self.weight, self.mode),
                                    self.bias, self.stride, self.padding, self.output_padding,
                                    self.groups, self.dilation), self.mode)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


class LeakyReLU(nn.Module):
    def forward(self, x):
        return F.leaky_relu(x, 0.01)


def conv_seq(specs, final_relu: bool = False) -> nn.Sequential:
    """conv → relu → conv ladder; specs (in, out, kernel, stride, padding)."""
    layers = []
    for i, (ci, co, k, s, p) in enumerate(specs):
        layers.append(Conv(ci, co, k, s, p))
        if i < len(specs) - 1 or final_relu:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class ResidualBlock(nn.Module):
    """Two 3×3 convs and a residual; a 1×1 projection where the shape changes.
    ``norm`` is ``"none"`` or ``"instance"``."""

    def __init__(self, in_planes: int, planes: int, norm: str = "none", stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride, 1)
        self.conv2 = Conv(planes, planes, 3, 1, 1)
        make = InstanceNorm if norm == "instance" else nn.Identity
        self.norm1, self.norm2 = make(), make()
        self.downsample = None
        if not (stride == 1 and in_planes == planes):
            self.norm3 = make()
            self.downsample = nn.Sequential(Conv(in_planes, planes, 1, stride, 0), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicConvIN(nn.Module):
    """Conv (or deconv), optional instance norm, LeakyReLU; no bias."""

    def __init__(self, ci, co, deconv=False, use_in=True, kernel=3, stride=1, padding=1):
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
    """Deconv upsample, add the skip, conv."""

    def __init__(self, ci: int, co: int, use_in: bool = True):
        super().__init__()
        self.conv1 = BasicConvIN(ci, co, deconv=True, use_in=True, kernel=4, stride=2, padding=1)
        self.conv2 = BasicConvIN(co, co, deconv=False, use_in=use_in)

    def forward(self, x, rem):
        x = self.conv1(x)
        if x.shape[2:] != rem.shape[2:]:
            x = ops.resize_nearest_nchw(x, rem.shape[2:])
        return self.conv2(x + rem)


# --- encoders ----------------------------------------------------------------

def _stage(ci, co, stride):
    return nn.Sequential(ResidualBlock(ci, co, "none", stride), ResidualBlock(co, co, "none", 1))


class MultiBasicEncoder(nn.Module):
    """Trunk on both images, context heads (net, inp) at three scales on
    image 1; returns (cnet_list fine→coarse, trunk)."""

    def __init__(self, output_dims):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 1, 3)
        self.norm1 = nn.Identity()
        self.layer1 = _stage(64, 64, 1)
        self.layer2 = _stage(64, 96, 2)
        self.layer3 = _stage(96, 128, 2)
        self.layer4 = _stage(128, 128, 2)
        self.layer5 = _stage(128, 128, 2)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, "none", 1), Conv(128, d[2], 3, 1, 1))
            for d in output_dims)
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, "none", 1), Conv(128, d[1], 3, 1, 1))
            for d in output_dims)
        self.outputs32 = nn.ModuleList(Conv(128, d[0], 3, 1, 1) for d in output_dims)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        trunk = self.layer3(self.layer2(self.layer1(x)))
        x = trunk[: trunk.shape[0] // 2]
        y = self.layer4(x)
        z = self.layer5(y)
        return (tuple(h(x) for h in self.outputs08), tuple(h(y) for h in self.outputs16),
                tuple(h(z) for h in self.outputs32)), trunk


class SharedBackboneHead(nn.Sequential):
    def __init__(self):
        super().__init__(ResidualBlock(128, 128, "instance", 1), Conv(128, 256, 3, 1, 1))


# --- update stack, completion and refinement heads ---------------------------

class ConvINConv(nn.Sequential):
    def __init__(self, ci, mid, out, stride=1):
        super().__init__(Conv(ci, mid, 3, stride, 1), InstanceNorm(), nn.ReLU(),
                         Conv(mid, out, 3, 1, 1))


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256, output_dim=1):
        super().__init__()
        self.conv1 = Conv(input_dim, hidden_dim, 3, 1, 1)
        self.conv2 = Conv(hidden_dim, output_dim, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class _GatedFuse(nn.Module):
    """h ← z·h + (1−z)·q, 1×1 gates on cat(h, x)."""

    def __init__(self, hidden_dim, input_dim):
        super().__init__()
        self.convzr = Conv(hidden_dim + input_dim, 2 * hidden_dim, 1, 1, 0)
        self.convq = Conv(hidden_dim + input_dim, hidden_dim, 1, 1, 0)

    def fuse(self, h, x):
        z, r = torch.chunk(self.convzr(torch.cat([h, x], dim=1)), 2, dim=1)
        z, r = torch.sigmoid(z), torch.sigmoid(r)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return z * h + (1 - z) * q


class LightFuse(_GatedFuse):
    def __init__(self, hidden_dim):
        super().__init__(hidden_dim, hidden_dim)

    def forward(self, h, x):
        return self.fuse(h, x)


class HiddenstateUpdater(_GatedFuse):
    def __init__(self, hidden_dim):
        super().__init__(hidden_dim, 64)
        self.convs = nn.Sequential(Conv(1, 64, 1, 1, 0), LeakyReLU(), Conv(64, 64, 1, 1, 0))

    def forward(self, h, delta_disp):
        return self.fuse(h, self.convs(_c(delta_disp)))


class ConvGRU(nn.Module):
    """h ← (1−z)·h + z·q with context gates cz, cr, cq added."""

    def __init__(self, hidden_dim, input_dim, kernel=3):
        super().__init__()
        self.convzr = Conv(hidden_dim + input_dim, 2 * hidden_dim, kernel, 1, kernel // 2)
        self.convq = Conv(hidden_dim + input_dim, hidden_dim, kernel, 1, kernel // 2)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=1)
        z, r = torch.chunk(self.convzr(torch.cat([h, x], dim=1)), 2, dim=1)
        z = torch.sigmoid(z + cz)
        r = torch.sigmoid(r + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes):
        super().__init__()
        self.convc1 = Conv(corr_planes, 64, 1, 1, 0)
        self.convc2 = Conv(64, 64, 3, 1, 1)
        self.convf1 = Conv(1, 64, 7, 1, 3)
        self.convf2 = Conv(64, 64, 3, 1, 1)
        self.conv = Conv(128, 127, 3, 1, 1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, flo], dim=1))), flow], dim=1)


class BasicMultiUpdateBlock(nn.Module):
    """Three ConvGRUs, coarse to fine; net[0] is the finest."""

    def __init__(self, hidden_dims, corr_planes):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru08 = ConvGRU(hidden_dims[2], 128 + hidden_dims[1])
        self.gru16 = ConvGRU(hidden_dims[1], hidden_dims[0] + hidden_dims[2])
        self.gru32 = ConvGRU(hidden_dims[0], hidden_dims[1])
        self.flow_head = FlowHead(hidden_dims[2], 256, 1)

    def forward(self, net, inp, corr, flow):
        net = list(net)
        net[2] = self.gru32(net[2], *inp[2], ops.pool2x_nchw(net[1]))
        net[1] = self.gru16(net[1], *inp[1], ops.pool2x_nchw(net[0]),
                            ops.resize_bilinear_nchw(net[2], net[1].shape[2:]))
        motion = self.encoder(flow, corr)
        net[0] = self.gru08(net[0], *inp[0], motion,
                            ops.resize_bilinear_nchw(net[1], net[0].shape[2:]))
        return tuple(net), self.flow_head(net[0])


class DispGradPredictor(nn.Module):
    """Refines the disparity gradient from 16 plane-gradient candidates."""

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
        disp_grad = 5.0 * disp_grad.detach()
        disp = disp.detach()
        B, H, W, _ = disp.shape
        cands = geometry.disp2disp_grad_candidates(disp, level=2).permute(0, 4, 3, 1, 2)
        x4_grad = self.conv_grad_stem(_c(disp_grad))
        x4_cand = self.conv_grad_candidate_stem(cands.reshape(B, 32, H, W))
        x4 = self.conv_4_4(torch.cat([x4_grad, x4_cand, clist[0]], dim=1))
        x8 = self.conv_8_8(torch.cat([self.conv_4_8(x4), clist[1]], dim=1))
        x16 = self.conv_16_16(torch.cat([self.conv_8_16(x8), clist[2]], dim=1))
        x4_up = self.conv_8_4(self.conv_16_8(x16, x8), x4)
        residual = _h(self.residual_head(x4_up))
        return (disp_grad + residual) / 5.0, self.conv_out(x4_up)


class UpsampleMaskHead(nn.Sequential):
    def __init__(self, factor):
        super().__init__(*conv_seq(((128, 256, 3, 1, 1), (256, 9 * factor ** 2, 1, 1, 0))))

    def forward(self, fused):
        return 0.25 * super().forward(fused)


def propagate_disparity(disp_grad, disp):
    """Planar extrapolation from the 3×3 neighbourhood: (candidates (B,H,W,9),
    |gradient differences| (B,H,W,18), the latter gradient-free)."""
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
    def __init__(self, hidden_dim, factor):
        super().__init__()
        self.context_compress = conv_seq(((hidden_dim + 64, 96, 3, 1, 1), (96, 96, 3, 1, 1)))
        self.disp_f_stem = conv_seq(((27, 96, 1, 1, 0), (96, 96, 1, 1, 0)))
        self.conv_fuse = conv_seq(((192, 128, 3, 1, 1), (128, 128, 3, 1, 1)), final_relu=True)
        self.w_head = conv_seq(((128, 128, 3, 1, 1), (128, 9, 1, 1, 0)))
        self.mask = UpsampleMaskHead(factor)

    def forward(self, disp_grads, disp, context_disp, context_grad):
        context = self.context_compress(torch.cat([context_disp, context_grad], dim=1))
        candidates, matrix = propagate_disparity(disp_grads, disp.detach())
        disp_f = self.disp_f_stem(_c(torch.cat([candidates.detach(), matrix], dim=-1)))
        fused = self.conv_fuse(torch.cat([disp_f, context], dim=1))
        w = torch.softmax(_h(self.w_head(fused)), dim=-1)
        return torch.sum(w * candidates, dim=-1, keepdim=True), fused


class DisparityCompletor(nn.Module):
    def __init__(self, c):
        super().__init__()
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
        disp_mono = _h(self.disp_head(x4_out))
        w = torch.sigmoid(_h(self.w_head(x4_out)))
        completed = (w * disp + (1 - w) * disp_mono) * 10.0
        nets = (self.conv_out4_disp(torch.cat([x4_out, context_list[0]], dim=1)),
                self.conv_out8_disp(torch.cat([x8_out, context_list[1]], dim=1)),
                self.conv_out16_disp(torch.cat([x16, context_list[2]], dim=1)))
        return completed, disp_mono * 10.0, w, nets


# --- the network -------------------------------------------------------------

def _hold(mode: str):
    """A forward hook that keeps a block's tensor outputs as ``mode`` does."""

    def hook(_module, _args, out):
        if isinstance(out, torch.Tensor):
            return precision.round_operand(out, mode)
        if isinstance(out, tuple):
            return tuple(precision.round_operand(o, mode) if isinstance(o, torch.Tensor) else o
                         for o in out)
        return out

    return hook


# Blocks whose outputs a conv stack in a lower precision holds in it: the
# residual and gated blocks, the GRUs and the hidden state's updaters.
_HELD = (ResidualBlock, BasicConvIN, Conv2xIN, ConvGRU, _GatedFuse, BasicMotionEncoder,
         InstanceNorm, nn.ReLU, LeakyReLU)


@dataclasses.dataclass
class State:
    """The carry between frames: previous disparity (B,h,w,1), hidden states
    (NHWC, fine→coarse), matching features (B,h,w,256), pose, and whether a
    previous frame exists."""

    disp_q: torch.Tensor
    net_list: Tuple[torch.Tensor, ...]
    fmap1: torch.Tensor
    T_prev: torch.Tensor
    valid: bool

    @staticmethod
    def zeros(batch, height, width, arch: Arch, device) -> "State":
        f = arch.factor
        h, w = height // f, width // f
        z = dict(dtype=torch.float32, device=device)
        return State(torch.zeros(batch, h, w, 1, **z),
                     tuple(torch.zeros(batch, h >> i, w >> i, arch.hidden_dims[i], **z)
                           for i in range(arch.n_gru_layers)),
                     torch.zeros(batch, h, w, 256, **z),
                     torch.eye(4, **z).expand(batch, 4, 4).clone(), False)


@dataclasses.dataclass
class Output:
    flow: torch.Tensor
    state: State
    flow_predictions: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    flow_q_predictions: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    disp_grad_q_predictions: Optional[torch.Tensor] = None
    flow_init: Optional[torch.Tensor] = None
    flow_mono: Optional[torch.Tensor] = None
    cost_volume: Optional[torch.Tensor] = None


class TCStereo(nn.Module):
    """One frame a call; images NHWC in [0, 255]; flow = −disparity."""

    def __init__(self, arch: Arch, mode: str = "fp32"):
        super().__init__()
        self.arch = arch
        self.mode = mode
        hd, cd = arch.hidden_dims, arch.context_dims
        n = arch.n_gru_layers
        self.cnet = MultiBasicEncoder((hd, cd))
        self.conv2 = SharedBackboneHead()
        self.context_zqr_convs = nn.ModuleList(Conv(cd[i], hd[i] * 3, 3, 1, 1) for i in range(n))
        self.context_zqr_convs_grad = nn.ModuleList(Conv(cd[i], 64, 3, 1, 1) for i in range(n))
        self.previous_current_hideen_fuse = nn.ModuleList(LightFuse(hd[i]) for i in range(n))
        self.disp_completor = DisparityCompletor(hd)
        self.update_block = BasicMultiUpdateBlock(hd, arch.corr_planes)
        self.disp_grad_refine = DispGradPredictor()
        self.disp_refine = DispRefine(hd[0], arch.factor)
        self.hiddenstate_update = HiddenstateUpdater(hd[0])
        for m in self.modules():
            if isinstance(m, (Conv, ConvTranspose)):
                m.mode = mode
            elif mode != "fp32" and isinstance(m, _HELD):
                m.register_forward_hook(_hold(mode))

    def iteration(self, disp, xs, net_list, inp_list, grad_list, pyramid):
        disp = disp.detach()
        corr = ops.lookup(pyramid, (xs - disp[..., 0]).contiguous(), self.arch.corr_radius)
        net_list, delta = self.update_block(net_list, inp_list, _c(corr), _c(-disp))
        disp_q = disp - _h(delta)
        grad_raw, _ = geometry.disp2disp_gradient_xy(disp_q.detach())
        disp_grad, grad_ctx = self.disp_grad_refine(grad_raw, disp_q, grad_list)
        refined, fused = self.disp_refine(disp_grad, disp_q, net_list[0], grad_ctx)
        net_list = (self.hiddenstate_update(net_list[0], (refined - disp_q).detach()),
                    ) + tuple(net_list[1:])
        return net_list, disp_q, refined, disp_grad, fused

    def forward(self, image1, image2, state: State, K, baseline, T, iters: int,
                train: bool = False) -> Output:
        if not train:
            with torch.no_grad():
                return self._frame(image1, image2, state, K, baseline, T, iters, False)
        return self._frame(image1, image2, state, K, baseline, T, iters, True)

    def _frame(self, image1, image2, state, K, baseline, T, iters, train):
        arch = self.arch
        B, H, W, _ = image1.shape
        f = arch.factor
        prev_disp, prev_fmap = state.disp_q.detach(), state.fmap1.detach()
        prev_nets = tuple(n.detach() for n in state.net_list)

        img = _c(2.0 * (torch.cat([image1, image2], dim=0) / 255.0) - 1.0)
        cnet_list, trunk = self.cnet(img)
        fmap = _h(self.conv2(trunk))
        fmap1, fmap2 = fmap[:B].contiguous(), fmap[B:]

        raw_cv = ops.build_cost_volume(fmap1, fmap2)
        pyramid = ops.store_pyramid(ops.corr_pyramid(raw_cv, arch.corr_levels), self.mode)
        cost_volume = None
        if train or not state.valid:
            cost_volume = ops.masked_cost_volume(raw_cv)

        K_scale = geometry.scale_intrinsics(K, 1.0 / f)
        K_scale_inv = torch.linalg.inv(K_scale)
        if state.valid:
            rel = geometry.cal_relative_transformation(state.T_prev, T)
            sparse_disp, warped_fmap1, sparse_mask = geometry.warp(
                prev_disp, prev_fmap, rel, K_scale, K_scale_inv, baseline)
            cost = torch.sum(ops.l2_normalize(fmap1.detach()) * ops.l2_normalize(warped_fmap1),
                             dim=-1, keepdim=True) * sparse_mask
        else:
            sparse_disp, cost, sparse_mask = ops.argmax_disp(
                cost_volume, arch.argmax_margin, arch.argmax_suppress_radius)

        inp_raw = [F.relu(x[1]) for x in cnet_list]
        grad_list = tuple(conv(x) for conv, x in zip(self.context_zqr_convs_grad, inp_raw))
        inp_list = tuple(torch.chunk(conv(x), 3, dim=1)
                         for conv, x in zip(self.context_zqr_convs, inp_raw))
        net_raw = [x[0] for x in cnet_list]
        disp_init, disp_mono, _, net_list = self.disp_completor(
            sparse_disp, cost.detach(), sparse_mask, net_raw)

        if state.valid:
            grid = geometry.get_backward_grid(
                disp_init.detach(), geometry.cal_relative_transformation(T, state.T_prev),
                K_scale, K_scale_inv, baseline)
            warped = []
            for net in prev_nets:
                warped.append(_c(ops.bilinear_sampler(net, grid)))
                grid = 0.5 * ops.resize_bilinear(grid, (grid.shape[1] // 2, grid.shape[2] // 2))
        else:
            warped = [torch.zeros_like(n) for n in net_list]
        net_list = tuple(fuse(torch.tanh(net), wnet) for fuse, net, wnet in
                         zip(self.previous_current_hideen_fuse, net_list, warped))

        disp = disp_init
        h, w = disp.shape[1:3]
        xs = torch.arange(w, dtype=torch.float32, device=disp.device)
        seqs = ([], [], [], [])
        for _ in range(iters):
            net_list, disp_q, refined, disp_grad, fused = self.iteration(
                disp, xs, net_list, inp_list, grad_list, pyramid)
            disp = refined
            if train:
                for s, x in zip(seqs, (disp_q, refined, disp_grad, fused)):
                    s.append(x)

        new_state = State(disp.detach().clamp(min=0.0),
                          tuple(_h(n.detach()).contiguous() for n in net_list),
                          fmap1.detach(), T, True)
        if not train:
            up_mask = self.disp_refine.mask(fused)
            flow = _h(ops.convex_upsample_nchw(_c(-disp), up_mask, f)).clamp(max=0.0)
            return Output(flow, new_state)

        disp_q_seq, refined_seq = torch.stack(seqs[0]), torch.stack(seqs[1])

        def fold(x):
            return _c(x.reshape(iters * B, h, w, 1))

        def unfold(x):
            return _h(x).reshape(iters, B, H, W, 1)

        up_mask = self.disp_refine.mask(torch.cat(seqs[3], dim=0))
        flows_up = unfold(ops.convex_upsample_nchw(fold(-disp_q_seq), up_mask.detach(), f))
        flow_refine_up = unfold(ops.convex_upsample_nchw(fold(-refined_seq), up_mask, f))
        return Output(flow_refine_up[-1].clamp(max=0.0), new_state,
                      flow_predictions=(flows_up, flow_refine_up),
                      flow_q_predictions=(-disp_q_seq, -refined_seq),
                      disp_grad_q_predictions=torch.stack(seqs[2]),
                      flow_init=-float(f) * ops.resize_bilinear(disp_init, (H, W)),
                      flow_mono=-float(f) * ops.resize_bilinear(disp_mono, (H, W)),
                      cost_volume=cost_volume)
