"""The frame-window training step (port of ``tcs_tpu/train/train_step.py``,
its default frame-inline formulation, ``:395-505``; reference
``train_stereo.py:348-415``).

For each frame of the window: one train-mode forward, the four losses, one
``backward()``. The temporal carries are detached, so the gradient of the
window's mean loss is the sum of the frames' gradients over the window
length; ``backward()`` adds into ``.grad`` and frees that frame's graph, so
one frame's activations are alive at a time. Then global-norm clipping and
AdamW under the one-cycle schedule.

Loss weighting follows ``train_stereo.py:364-405``:
total = Σ_frames (seq + init + 0.25·normal + 5·grad) / frame_length.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tcs_tpu_torch import losses as L
from tcs_tpu_torch.config import TrainConfig
from tcs_tpu_torch.geometry import disp2disp_gradient_xy
from tcs_tpu_torch.models.tc_stereo import (
    CameraParams,
    TCStereo,
    TCStereoOutput,
    TemporalState,
)
from tcs_tpu_torch.train import optim


@dataclasses.dataclass
class FrameBatch:
    """One temporal frame for every sequence in the batch."""

    image1: torch.Tensor  # (B, H, W, 3) float32 in [0, 255]
    image2: torch.Tensor  # (B, H, W, 3)
    flow: torch.Tensor  # (B, H, W, 1) GT flow (−disp)
    valid: torch.Tensor  # (B, H, W, 1) float 0/1
    T: torch.Tensor  # (B, 4, 4) world→cam pose


@dataclasses.dataclass
class SequenceBatch:
    """A batch of fixed-length stereo video clips."""

    image1: torch.Tensor  # (B, T, H, W, 3)
    image2: torch.Tensor  # (B, T, H, W, 3)
    flow: torch.Tensor  # (B, T, H, W, 1)
    valid: torch.Tensor  # (B, T, H, W, 1)
    T: torch.Tensor  # (B, T, 4, 4)
    K: torch.Tensor  # (B, 3, 3)
    baseline: torch.Tensor  # (B,)

    def frame(self, t: int) -> FrameBatch:
        return FrameBatch(image1=self.image1[:, t], image2=self.image2[:, t],
                          flow=self.flow[:, t], valid=self.valid[:, t],
                          T=self.T[:, t])

    @staticmethod
    def from_numpy(samples, device) -> "SequenceBatch":
        """Stack per-clip dicts of numpy arrays (keys as the fields above, as
        ``data.synthetic.SyntheticStereoSequence.load_sample`` makes them)."""
        return SequenceBatch(**{
            k: torch.as_tensor(np.stack([np.asarray(s[k], np.float32) for s in samples]),
                               device=device)
            for k in ("image1", "image2", "flow", "valid", "T", "K", "baseline")})


def frame_losses(out: TCStereoOutput, frame: FrameBatch, cfg: TrainConfig):
    """All four losses of one frame (reference train_stereo.py:363-399):
    (total, metrics). Masked means are over the frame's own valid count."""
    weights = L.loss_weights(out.flow_predictions[0].shape[0], cfg.loss_gamma,
                             device=frame.flow.device)
    scale = cfg.model.scale_rate
    with torch.no_grad():  # the GT side carries no gradient
        mag = torch.sqrt(torch.sum(frame.flow ** 2, dim=-1, keepdim=True))
        valid = (frame.valid >= 0.5) & (mag < 700.0)
        grad_gt, _ = disp2disp_gradient_xy(-frame.flow)
        norm_gt = torch.cat([grad_gt, -torch.ones_like(grad_gt[..., :1])], dim=-1)
        norm_gt = norm_gt / torch.linalg.vector_norm(
            norm_gt, dim=-1, keepdim=True).clamp(min=1e-12)
    dense_gt = cfg.train_dataset != "kitti_raw"

    seq_loss, seq_metrics = L.sequence_loss(
        out.flow_mono, out.flow_init, out.flow_predictions, frame.flow, valid, weights)
    in_loss, init_metrics = L.init_loss(
        out.cost_volume, frame.flow, valid, k=cfg.init_k, scale=scale,
        threshold=cfg.model.init_thres)
    norm_loss, norm_metrics = L.disp_normal_loss(
        out.flow_q_predictions, norm_gt, valid, weights, scale=scale,
        dense_gt=dense_gt)
    grad_loss, grad_metrics = L.disp_grad_loss(
        out.disp_grad_q_predictions, grad_gt, valid, weights, scale=scale,
        dense_gt=dense_gt)
    total = (seq_loss + in_loss + cfg.normal_loss_weight * norm_loss
             + cfg.grad_loss_weight * grad_loss)
    return total, {**seq_metrics, **init_metrics, **norm_metrics, **grad_metrics}


def accumulate_window_grads(model: TCStereo, cfg: TrainConfig, batch: SequenceBatch,
                            mark: Optional[Callable[[str], None]] = None
                            ) -> Dict[str, torch.Tensor]:
    """Forward, losses and backward of every frame of the window.

    Leaves Σ_t ∂loss_t/∂θ · (1/T) in the parameters' ``.grad`` and returns the
    metrics, each the mean over the frames, with ``live_loss`` the mean frame
    loss. Metrics stay on the device. A profiler's ``mark`` is called with
    ``"forward"`` after each frame's forward and losses and with
    ``"backward"`` after each frame's backward.
    """
    B, Tn, H, W, _ = batch.image1.shape
    cam = CameraParams(K=batch.K, baseline=batch.baseline)
    state = TemporalState.zeros(B, H, W, cfg.model, device=batch.image1.device)
    model.zero_grad(set_to_none=True)
    sums: Dict[str, torch.Tensor] = {}
    for t in range(Tn):
        frame = batch.frame(t)
        out = model(frame.image1, frame.image2, state, cam, frame.T,
                    iters=cfg.train_iters, test_mode=False)
        loss, metrics = frame_losses(out, frame, cfg)
        if mark is not None:
            mark("forward")
        # Scaling the loss scales this frame's gradients by 1/T as they are
        # added into .grad; the graph of the frame is freed here.
        (loss / Tn).backward()
        if mark is not None:
            mark("backward")
        state = out.new_state
        metrics["live_loss"] = loss.detach()
        for k, v in metrics.items():
            sums[k] = sums[k] + v if k in sums else v
    return {k: v / Tn for k, v in sums.items()}


def make_train_step(model: TCStereo, cfg: TrainConfig
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the train step: ``step(batch) → metrics``.

    The callable holds the optimiser and the scheduler (``step.optimizer``,
    ``step.scheduler``) and updates ``model`` in place. ``metrics`` holds the
    losses' metrics averaged over the frames, ``live_loss`` (the mean frame
    loss) and ``grad_norm``, the global norm of the 1/T-scaled gradients
    before clipping, as 0-d tensors on the model's device. ``step(batch,
    mark)`` also calls a profiler's ``mark`` at the step's seams:
    ``"forward"`` and ``"backward"`` per frame (see
    :func:`accumulate_window_grads`) and ``"update"`` after the gradient
    norm, the clip, AdamW and the scheduler.

    The model stays in the mode it was built in: the default architecture has
    no layer with running statistics or dropout (instance norms are computed
    per sample, ``context_norm='none'``), so ``train()`` and ``eval()`` are
    the same function; train mode here means ``test_mode=False``.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer, scheduler = optim.make_optimizer(params, cfg)

    def step(batch: SequenceBatch, mark: Optional[Callable[[str], None]] = None
             ) -> Dict[str, torch.Tensor]:
        metrics = accumulate_window_grads(model, cfg, batch, mark)
        for p in params:
            # A parameter no loss reaches (the hidden updater at 1 iteration)
            # has a zero gradient in tcs_tpu; AdamW would skip it at None.
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = optim.global_norm(grads)
        optim.clip_by_global_norm_(grads, norm, cfg.grad_clip)
        optimizer.step()
        scheduler.step()
        if mark is not None:
            mark("update")
        metrics["grad_norm"] = norm
        return metrics

    step.optimizer = optimizer
    step.scheduler = scheduler
    return step
