"""TCStereo (port of ``tcs_tpu/models/tc_stereo.py:319-594``).

One call is one frame, of streaming temporal inference in test mode or of a
training window in train mode:

1. the encoders: on the shared backbone the trunk on both images,
   batch-stacked, and the matching head on it; otherwise the context encoder
   on image 1 and ``BasicEncoder`` on both images, batch-stacked;
2. the fp32 cosine cost volume and its pyramid, stored in ``corr_dtype``;
3. the disparity initialisation: on the first frame of a sequence the
   cost-volume argmax bootstrap, on later frames the forward softmax splat
   of the previous disparity and features along the pose-induced flow, plus
   the bilinear back-warp of the previous hidden states;
4. ``iters`` GRU / dual-space refinement iterations, each with one radius
   lookup across the pyramid (with ``slow_fast_gru`` the coarse GRUs run two
   pre-passes ahead of each update);
5. convex upsampling: of the last iteration in test mode, of every
   iteration (folded into the batch) in train mode, which also returns the
   per-iteration predictions, the upsampled initialisations and the masked
   cost volume that the losses read.

Test mode runs under ``torch.no_grad()``. In train mode every stop-gradient
of the JAX model is a ``.detach()`` at the same place; the temporal state is
detached where it comes in and where it goes out, so one frame's backward
never reaches another frame.

Each call is a ``model.frame`` span (:func:`profiling.span`) around one
span a stage: ``model.encode``, ``model.cost_volume``, ``model.argmax`` or
``model.warp``, ``model.context``, ``model.completion``,
``model.state_warp``, ``model.iter`` once an iteration, ``model.upsample``.

Images are NHWC in [0, 255]; :class:`TemporalState` keeps the JAX package's
layouts. ``state.valid`` is a host-side bool, so choosing the path needs no
device synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcs_tpu_torch import device as device_lib
from tcs_tpu_torch import geometry
from tcs_tpu_torch.config import ModelConfig
from tcs_tpu_torch.models.extractor import (
    BasicEncoder,
    MultiBasicEncoder,
    SharedBackboneHead,
)
from tcs_tpu_torch.models.layers import Conv, ConvTranspose, set_compute_dtype
from tcs_tpu_torch.models.update import (
    BasicMultiUpdateBlock,
    DispGradPredictor,
    DispRefine,
    DisparityCompletor,
    HiddenstateUpdater,
    LightFuse,
)
from tcs_tpu_torch.ops import corr as corr_ops
from tcs_tpu_torch.ops.sampler import (
    bilinear_sampler,
    convex_upsample_nchw,
    resize_bilinear,
)
from tcs_tpu_torch.ops.sampler import to_nchw as _c
from tcs_tpu_torch.ops.sampler import to_nhwc as _h
from tcs_tpu_torch.utils import profiling


@dataclasses.dataclass
class CameraParams:
    """Stereo intrinsics at full image resolution: K (B,3,3), baseline (B,)."""

    K: torch.Tensor
    baseline: torch.Tensor


@dataclasses.dataclass
class TemporalState:
    """State carried between frames (reference tc_stereo.py:223-243).

    ``valid`` is False on the first frame of a sequence (zeros / identity
    pose; the argmax bootstrap runs) and True after it.
    """

    disp_q: torch.Tensor  # (B, H/f, W/f, 1) previous disparity, ≥ 0
    net_list: Tuple[torch.Tensor, ...]  # (B, h_i, w_i, C) hidden states, fine→coarse
    fmap1: torch.Tensor  # (B, H/f, W/f, 256) previous matching features
    T_prev: torch.Tensor  # (B, 4, 4) previous world→cam pose
    valid: bool

    @staticmethod
    def zeros(batch: int, height: int, width: int, cfg: ModelConfig,
              device=None) -> "TemporalState":
        dev = device_lib.resolve(device)
        f = cfg.downsample_factor
        h, w = height // f, width // f
        z = dict(dtype=torch.float32, device=dev)
        return TemporalState(
            disp_q=torch.zeros(batch, h, w, 1, **z),
            net_list=tuple(torch.zeros(batch, h >> i, w >> i, cfg.hidden_dims[i], **z)
                           for i in range(cfg.n_gru_layers)),
            fmap1=torch.zeros(batch, h, w, 256, **z),
            T_prev=torch.eye(4, **z).expand(batch, 4, 4).clone(),
            valid=False,
        )


@dataclasses.dataclass
class TCStereoOutput:
    """Forward outputs. The training fields are None in test mode."""

    flow: torch.Tensor  # (B, H, W, 1) full-resolution flow of the last iteration, ≤ 0
    new_state: TemporalState
    flow_predictions: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # (iters,B,H,W,1) ×2
    flow_q_predictions: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # (iters,B,h,w,1) ×2
    disp_grad_q_predictions: Optional[torch.Tensor] = None  # (iters,B,h,w,2)
    flow_init: Optional[torch.Tensor] = None  # (B,H,W,1) upsampled −disp_init
    flow_mono: Optional[torch.Tensor] = None  # (B,H,W,1) upsampled −disp_mono
    cost_volume: Optional[torch.Tensor] = None  # (B,h,w,W2) masked


class TCStereo(nn.Module):
    """Iterative temporally-consistent stereo network.

    Module names follow the reference torch model, so ``state_dict()`` feeds
    ``tools/convert_torch_ckpt.convert_state_dict`` and reference checkpoints
    load with ``strict=True``. Weights are drawn from ``seed`` with torch's
    default conv init; :func:`tcs_tpu_torch.convert.state_dict_from_jax`
    loads the JAX package's parameters.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig(), device=None, seed: int = 0):
        super().__init__()
        dev = device_lib.resolve(device)
        self.cfg = cfg
        hd, cd = cfg.hidden_dims, cfg.context_dims
        self.cnet = MultiBasicEncoder((hd, cd), cfg.context_norm)
        if cfg.shared_backbone:
            self.conv2 = SharedBackboneHead()
        else:
            self.fnet = BasicEncoder(256, "instance", cfg.n_downsample)
        n = cfg.n_gru_layers
        self.context_zqr_convs = nn.ModuleList(
            Conv(cd[i], hd[i] * 3, 3, 1, 1) for i in range(n))
        self.context_zqr_convs_grad = nn.ModuleList(
            Conv(cd[i], 64, 3, 1, 1) for i in range(n))
        self.previous_current_hideen_fuse = nn.ModuleList(LightFuse(hd[i]) for i in range(n))
        self.disp_completor = DisparityCompletor(hd)
        self.update_block = BasicMultiUpdateBlock(hd, cfg.corr_planes)
        self.disp_grad_refine = DispGradPredictor()
        self.disp_refine = DispRefine(hd[0], cfg.downsample_factor)
        self.hiddenstate_update = HiddenstateUpdater(hd[0])
        self.dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        set_compute_dtype(self, self.dtype)
        self._init_weights(seed)
        self.to(dev)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """torch's default conv init, U(±1/√fan_in), from an explicit generator."""
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv, ConvTranspose)):
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                bound = fan_in ** -0.5
                m.weight.uniform_(-bound, bound, generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=g)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                state: TemporalState, cam: CameraParams, T: torch.Tensor,
                iters: int = 5, test_mode: bool = True) -> TCStereoOutput:
        """One frame. image1/2 (B,H,W,3) in [0,255]; T (B,4,4) world→cam pose.

        ``test_mode=True`` builds no autograd graph and returns the final flow
        and the new state only; ``test_mode=False`` also returns the
        per-iteration training outputs and is differentiable.
        """
        if iters < 1:
            raise ValueError(f"iters={iters}: at least one refinement iteration")
        with profiling.span("model.frame"):
            if test_mode:
                with torch.no_grad():
                    return self._frame(image1, image2, state, cam, T, iters, True)
            return self._frame(image1, image2, state, cam, T, iters, False)

    def iteration(self, disp, xs, net_list, inp_list, grad_list, pyramid):
        """One GRU / dual-space refinement iteration with its radius lookup:
        disp (B,h,w,1) and xs (the w column indices) → (net_list, disp_q,
        refined, disp_grad, fused)."""
        cfg = self.cfg
        disp = disp.detach()
        coords_x = (xs - disp[..., 0]).contiguous()
        corr = corr_ops.lookup(pyramid, coords_x, cfg.corr_radius)
        if cfg.slow_fast_gru:
            net_list = self.update_block(net_list, inp_list, iter_fine=False,
                                         iter_mid=False, update=False)
            net_list = self.update_block(net_list, inp_list, iter_fine=False,
                                         update=False)
        net_list, delta_flow = self.update_block(net_list, inp_list, _c(corr),
                                                 _c(-disp), self.dtype)
        disp_q = disp - _h(delta_flow)
        disp_grad_raw, _ = geometry.disp2disp_gradient_xy(disp_q.detach())
        disp_grad, grad_ctx = self.disp_grad_refine(disp_grad_raw, disp_q, grad_list)
        refined, fused = self.disp_refine(disp_grad, disp_q, net_list[0], grad_ctx)
        net_list = (self.hiddenstate_update(net_list[0], (refined - disp_q).detach()),
                    ) + tuple(net_list[1:])
        return net_list, disp_q, refined, disp_grad, fused

    def _frame(self, image1, image2, state, cam, T, iters, test_mode):
        cfg = self.cfg
        B, H, W, _ = image1.shape
        f = cfg.downsample_factor
        # The carry is gradient-free where it is produced (new_state below)
        # and, as in the JAX model, where it is consumed.
        state = dataclasses.replace(
            state, disp_q=state.disp_q.detach(), fmap1=state.fmap1.detach(),
            net_list=tuple(n.detach() for n in state.net_list))

        # --- context + matching features ---
        with profiling.span("model.encode"):
            img = _c(2.0 * (torch.cat([image1, image2], dim=0) / 255.0) - 1.0)
            if cfg.shared_backbone:
                cnet_list, trunk = self.cnet(img, dual_inp=True)
                fmap = _h(self.conv2(trunk)).float()
            else:
                cnet_list, _ = self.cnet(img[:B], dual_inp=False)
                fmap = _h(self.fnet(img)).float()
            fmap1, fmap2 = fmap[:B].contiguous(), fmap[B:]

        # --- cost volume (fp32) and pyramid (corr_dtype) ---
        with profiling.span("model.cost_volume"):
            raw_cv = corr_ops.build_cost_volume(fmap1, fmap2)
            corr_dt = getattr(torch, cfg.corr_dtype)
            pyramid = tuple(lvl.to(corr_dt).contiguous()
                            for lvl in corr_ops.corr_pyramid(raw_cv, cfg.corr_levels))
            cost_volume = None
            if not (test_mode and state.valid):
                cost_volume = corr_ops.masked_cost_volume(raw_cv)

        # --- temporal initialisation ---
        with profiling.span("model.warp" if state.valid else "model.argmax"):
            K_scale = geometry.scale_intrinsics(cam.K, cfg.scale_rate)
            K_scale_inv = torch.linalg.inv(K_scale)
            if state.valid:
                rel = geometry.cal_relative_transformation(state.T_prev, T)
                sparse_disp, warped_fmap1, sparse_mask = geometry.warp(
                    state.disp_q, state.fmap1, rel, K_scale, K_scale_inv, cam.baseline)
                cost = torch.sum(corr_ops.l2_normalize(fmap1.detach())
                                 * corr_ops.l2_normalize(warped_fmap1),
                                 dim=-1, keepdim=True) * sparse_mask
            else:
                sparse_disp, cost, sparse_mask = corr_ops.argmax_disp(
                    cost_volume, margin=cfg.argmax_margin,
                    suppress_radius=cfg.argmax_suppress_radius)

        # --- context projections ---
        with profiling.span("model.context"):
            inp_raw = [F.relu(x[1]) for x in cnet_list]
            grad_list = tuple(conv(x) for conv, x in zip(self.context_zqr_convs_grad, inp_raw))
            inp_list = tuple(torch.chunk(conv(x), 3, dim=1)
                             for conv, x in zip(self.context_zqr_convs, inp_raw))
            net_raw = [x[0] for x in cnet_list]

        # --- disparity completion (the cost is an input, not a path for
        # gradients: the init loss trains the cost volume) ---
        with profiling.span("model.completion"):
            disp_init, disp_mono, _, net_list = self.disp_completor(
                sparse_disp, cost.detach(), sparse_mask, net_raw)

        # --- hidden-state temporal warp and fusion ---
        with profiling.span("model.state_warp"):
            if state.valid:
                grid = geometry.get_backward_grid(
                    disp_init.detach(), geometry.cal_relative_transformation(T, state.T_prev),
                    K_scale, K_scale_inv, cam.baseline)
                warped = []
                for net in state.net_list:
                    warped.append(_c(bilinear_sampler(net.float(), grid)))
                    grid = 0.5 * resize_bilinear(grid, (grid.shape[1] // 2,
                                                        grid.shape[2] // 2))
            else:
                warped = [torch.zeros_like(n, dtype=torch.float32) for n in net_list]
            net_list = tuple(fuse(torch.tanh(net), wnet) for fuse, net, wnet in
                             zip(self.previous_current_hideen_fuse, net_list, warped))

        # --- iterative refinement ---
        disp = disp_init
        h, w = disp.shape[1:3]
        xs = torch.arange(w, dtype=torch.float32, device=disp.device)
        disp_q_seq, refined_seq, grads_seq, fused_seq = [], [], [], []
        for _ in range(iters):
            with profiling.span("model.iter"):
                net_list, disp_q, refined, disp_grad, fused = self.iteration(
                    disp, xs, net_list, inp_list, grad_list, pyramid)
            disp = refined
            if not test_mode:
                disp_q_seq.append(disp_q)
                refined_seq.append(refined)
                grads_seq.append(disp_grad)
                fused_seq.append(fused)

        new_state = TemporalState(
            disp_q=disp.detach().clamp(min=0.0),
            net_list=tuple(_h(n.detach()).float().contiguous() for n in net_list),
            fmap1=fmap1.detach(),
            T_prev=T,
            valid=True,
        )
        with profiling.span("model.upsample"):
            if test_mode:
                # Mask head and convex upsampling on the last iteration only.
                up_mask = self.disp_refine.mask(fused)
                flow = _h(convex_upsample_nchw(_c(-disp), up_mask, f)).clamp(max=0.0)
                return TCStereoOutput(flow=flow, new_state=new_state)

            # Train: the iteration axis folds into the batch, so the mask head and
            # the upsampling run once over all iterations (per-pixel operations,
            # so the numbers are those of a per-iteration application).
            disp_q_seq, refined_seq = torch.stack(disp_q_seq), torch.stack(refined_seq)

            def fold(x):  # (iters, B, h, w, 1) → (iters·B, 1, h, w)
                return _c(x.reshape(iters * B, h, w, 1))

            def unfold(x):  # (iters·B, 1, H, W) → (iters, B, H, W, 1)
                return _h(x).reshape(iters, B, H, W, 1)

            up_mask = self.disp_refine.mask(torch.cat(fused_seq, dim=0))
            flows_up = unfold(convex_upsample_nchw(fold(-disp_q_seq), up_mask.detach(), f))
            flow_refine_up = unfold(convex_upsample_nchw(fold(-refined_seq), up_mask, f))
            return TCStereoOutput(
                flow=flow_refine_up[-1].clamp(max=0.0),
                new_state=new_state,
                flow_predictions=(flows_up, flow_refine_up),
                flow_q_predictions=(-disp_q_seq, -refined_seq),
                disp_grad_q_predictions=torch.stack(grads_seq),
                flow_init=-float(f) * resize_bilinear(disp_init, (H, W)),
                flow_mono=-float(f) * resize_bilinear(disp_mono, (H, W)),
                cost_volume=cost_volume,
            )
