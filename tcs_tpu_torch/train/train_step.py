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

Given a model that ``parallel.mesh.wrap`` put under DDP, the step computes
``tcs_tpu``'s function of the global batch (``parallel/mesh.py``): each
frame's mask counts are summed over the ranks while its forward runs, the
frames before the last accumulate their gradients under ``no_sync()``, the
last frame's backward sums the window's gradients over the ranks, and the
metrics are summed over the ranks once a step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from tcs_tpu_torch import losses as L
from tcs_tpu_torch.config import TrainConfig
from tcs_tpu_torch.geometry import disp2disp_gradient_xy
from tcs_tpu_torch.models.tc_stereo import CameraParams, TCStereoOutput, TemporalState
from tcs_tpu_torch.parallel import mesh
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

    @staticmethod
    def from_loader(batch: Dict[str, np.ndarray], device) -> "SequenceBatch":
        """A batch of ``data.loader.SequenceLoader`` (float32 numpy arrays, or
        tensors in pinned memory) on ``device``. To a GPU each array goes
        through pinned host memory (a pinned tensor as it is), with a copy
        that does not wait for the device."""
        device = torch.device(device)

        def put(a) -> torch.Tensor:
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a, np.float32))
            if device.type == "cuda":
                return t.pin_memory().to(device, torch.float32, non_blocking=True)
            return t.to(device, torch.float32)

        return SequenceBatch(**{k: put(batch[k]) for k in (
            "image1", "image2", "flow", "valid", "T", "K", "baseline")})


@dataclasses.dataclass
class FrameTargets:
    """The ground-truth side of one frame's four losses, which needs no
    forward: the valid mask, each loss's targets, and ``counts``, the masks'
    counts (valid, init mask, init cells, normal, grad) of this batch or,
    once summed over the ranks, of the global batch. ``init_offset`` is the
    init loss's constant, which one rank of a process group adds."""

    valid: torch.Tensor  # (B, H, W, 1) bool
    init: L.InitTargets
    normal: Tuple[torch.Tensor, torch.Tensor]
    grad: Tuple[torch.Tensor, torch.Tensor]
    counts: torch.Tensor  # (5,) float32
    init_offset: float = 1.0


@torch.no_grad()
def frame_targets(frame: FrameBatch, cfg: TrainConfig, grid=None) -> FrameTargets:
    """:class:`FrameTargets` of ``frame``; ``grid`` is the cost volume's
    (B, h, w, W2), by default the model's at the frame's size (a quarter
    of it, each side rounded up as the encoder's strided convolutions round
    it, and W2 = w)."""
    B, H, W, _ = frame.flow.shape
    if grid is None:
        f = cfg.model.downsample_factor
        w = -(-W // f)
        grid = (B, -(-H // f), w, w)
    scale = cfg.model.scale_rate
    dense_gt = cfg.train_dataset != "kitti_raw"
    mag = torch.sqrt(torch.sum(frame.flow ** 2, dim=-1, keepdim=True))
    valid = (frame.valid >= 0.5) & (mag < 700.0)
    grad_gt, _ = disp2disp_gradient_xy(-frame.flow)
    norm_gt = torch.cat([grad_gt, -torch.ones_like(grad_gt[..., :1])], dim=-1)
    norm_gt = norm_gt / torch.linalg.vector_norm(norm_gt, dim=-1, keepdim=True).clamp(min=1e-12)
    init = L.init_targets(frame.flow, valid, grid, scale=scale)
    normal = L.normal_targets(norm_gt, valid, scale, dense_gt)
    grad = L.grad_targets(grad_gt, valid, scale, dense_gt)
    cells = torch.full((), float(init.mask.numel()), device=valid.device)  # no host sync
    counts = torch.stack([valid.float().sum(), init.mask.float().sum(), cells,
                          normal[1].float().sum(), grad[1].float().sum()])
    return FrameTargets(valid, init, normal, grad, counts)


def frame_losses(out: TCStereoOutput, frame: FrameBatch, cfg: TrainConfig,
                 targets: Optional[FrameTargets] = None):
    """All four losses of one frame (reference train_stereo.py:363-399):
    (total, metrics). Masked means are over ``targets.counts``, by default
    the frame's own."""
    if targets is None:
        targets = frame_targets(frame, cfg, out.cost_volume.shape)
    elif targets.init.suppress.shape != out.cost_volume.shape:
        raise ValueError(f"targets for a cost volume of {tuple(targets.init.suppress.shape)}, "
                         f"the model made {tuple(out.cost_volume.shape)}")
    weights = L.loss_weights(out.flow_predictions[0].shape[0], cfg.loss_gamma,
                             device=frame.flow.device)
    scale = cfg.model.scale_rate
    dense_gt = cfg.train_dataset != "kitti_raw"
    n_valid, n_init, cells, n_normal, n_grad = targets.counts.unbind()
    valid = targets.valid

    seq_loss, seq_metrics = L.sequence_loss(
        out.flow_mono, out.flow_init, out.flow_predictions, frame.flow, valid, weights,
        count=n_valid)
    in_loss, init_metrics = L.init_loss(
        out.cost_volume, frame.flow, valid, k=cfg.init_k, scale=scale,
        threshold=cfg.model.init_thres, targets=targets.init, counts=(n_init, cells),
        offset=targets.init_offset)
    norm_loss, norm_metrics = L.disp_normal_loss(
        out.flow_q_predictions, None, valid, weights, scale=scale,
        dense_gt=dense_gt, targets=targets.normal, count=n_normal)
    grad_loss, grad_metrics = L.disp_grad_loss(
        out.disp_grad_q_predictions, None, valid, weights, scale=scale,
        dense_gt=dense_gt, targets=targets.grad, count=n_grad)
    total = (seq_loss + in_loss + cfg.normal_loss_weight * norm_loss
             + cfg.grad_loss_weight * grad_loss)
    return total, {**seq_metrics, **init_metrics, **norm_metrics, **grad_metrics}


def accumulate_window_grads(model: nn.Module, cfg: TrainConfig, batch: SequenceBatch,
                            mark: Optional[Callable[[str], None]] = None
                            ) -> Dict[str, torch.Tensor]:
    """Forward, losses and backward of every frame of the window.

    Leaves Σ_t ∂loss_t/∂θ · (1/T) in the parameters' ``.grad`` and returns the
    metrics, each the mean over the frames, with ``live_loss`` the mean frame
    loss. Metrics stay on the device. A profiler's ``mark`` is called with
    ``"forward"`` after each frame's forward and losses and with
    ``"backward"`` after each frame's backward.

    ``model`` under DDP (``parallel.mesh.wrap``): the loss of each rank is
    its share of the global batch's, the gradient left in ``.grad`` is the
    global batch's on every rank, and the metrics are this rank's shares
    (the train step sums them over the ranks).
    """
    ddp = isinstance(model, DistributedDataParallel)
    B, Tn, H, W, _ = batch.image1.shape
    cam = CameraParams(K=batch.K, baseline=batch.baseline)
    state = TemporalState.zeros(B, H, W, cfg.model, device=batch.image1.device)
    model.zero_grad(set_to_none=True)
    sums: Dict[str, torch.Tensor] = {}
    for t in range(Tn):
        frame = batch.frame(t)
        targets = frame_targets(frame, cfg)
        counted = mesh.all_reduce_sum(targets.counts, async_op=True) if ddp else None
        # The gradients of the frames before the last stay on this rank;
        # the last frame's backward sums the window's over the ranks.
        with model.no_sync() if ddp and t < Tn - 1 else contextlib.nullcontext():
            out = model(frame.image1, frame.image2, state, cam, frame.T,
                        iters=cfg.train_iters, test_mode=False)
            if counted is not None:
                counted.wait()
                targets.init_offset = float(mesh.is_primary())
            loss, metrics = frame_losses(out, frame, cfg, targets)
            if mark is not None:
                mark("forward")
            # Scaling the loss scales this frame's gradients by 1/T as they
            # are added into .grad; the graph of the frame is freed here.
            (loss / Tn).backward()
        if mark is not None:
            mark("backward")
        state = out.new_state
        metrics["live_loss"] = loss.detach()
        for k, v in metrics.items():
            sums[k] = sums[k] + v if k in sums else v
    return {k: v / Tn for k, v in sums.items()}


def make_train_step(model: nn.Module, cfg: TrainConfig
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

    The model stays in the mode it was built in: no architecture has a layer
    with running statistics or dropout (instance norms are per sample, batch
    norms always take the batch's statistics), so ``train()`` and ``eval()``
    are the same function; train mode here means ``test_mode=False``.

    ``model`` may be under DDP (``parallel.mesh.wrap``): then the metrics are
    the global batch's, summed over the ranks in one all-reduce with the
    host values of ``step(batch, extra={name: float})`` (the trainer's
    SIGTERM flag), which come back summed under their names. ``grad_norm``
    is read from the summed gradients, the same on every rank.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer, scheduler = optim.make_optimizer(params, cfg)

    def step(batch: SequenceBatch, mark: Optional[Callable[[str], None]] = None,
             extra: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
        metrics = accumulate_window_grads(model, cfg, batch, mark)
        for k, v in (extra or {}).items():
            metrics[k] = torch.full((), float(v), device=params[0].device)
        for p in params:
            # A parameter no loss reaches (the hidden updater at 1 iteration)
            # has a zero gradient in tcs_tpu; AdamW would skip it at None.
            # Under DDP its gradient has been reduced by now.
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = optim.global_norm(grads)
        optim.clip_by_global_norm_(grads, norm, cfg.grad_clip)
        optimizer.step()
        scheduler.step()
        if isinstance(model, DistributedDataParallel):
            metrics = mesh.sum_over_ranks(metrics)
        if mark is not None:
            mark("update")
        metrics["grad_norm"] = norm
        return metrics

    step.optimizer = optimizer
    step.scheduler = scheduler
    return step
