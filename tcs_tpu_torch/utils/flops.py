"""Model FLOPs of the port, counted by function, and the cards' published peaks.

The convention. Model FLOPs are 2 × the multiply-adds of the function the
model computes, whichever implementation runs:

- convolutions as ``torch.utils.flop_counter`` counts them: a transposed
  convolution over its input, not over a zero-dilated one; a convolution's
  backward as one forward convolution for each of its two gradients taken;
- matrix products likewise; the cost volume is one product, counted once;
- the three functions that the port computes in hand-written kernels or
  outside any counted op are counted at their public entries, by their
  taps, one multiply-add each: ``ops.corr.lookup`` 2 taps a lookup output,
  ``ops.splat.splat_sum`` 4 taps a splatted payload element, and
  ``ops.sampler.convex_upsample_nchw`` 9 taps × f² × D a low-resolution
  pixel. Their backward counts the forward's taps again for each input that
  takes a gradient. Nothing inside these entries is counted, so the plain
  versions on the CPU and the kernels on the card give one number;
- left out: recompute (the port recomputes nothing), the zero blocks of a
  packed weight (the port packs none), pools, and elementwise work: norms,
  activations, GRU gates, losses and the optimiser. About half of the
  device time is elementwise, so a share of peak taken from this count says
  nothing about that half.

:class:`FlopCounter` counts under ``FlopCounterMode``, by module path and
by op, with the forward and the backward apart;
:func:`inference_flops` and :func:`train_step_flops` count one frame and
one training step. :func:`peak` reads a card's published dense rates.

This module imports nothing of the port at import time, so that a bench
script may load it by path beside another tree's package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from collections import defaultdict
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


@dataclasses.dataclass(frozen=True)
class Peak:
    """A card's published dense rates (no sparsity), FLOP/s and bytes/s."""

    bf16: float
    fp16: float
    tf32: float
    fp32: float  # outside the tensor cores
    hbm_bytes_per_s: float


# NVIDIA's data sheets (H100 Tensor Core GPU, H200), dense rates, at each
# part's full power limit; keyed by ``torch.cuda.get_device_name``.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peak(989e12, 989e12, 495e12, 67e12, 3.35e12),  # SXM5
    "NVIDIA H100 PCIe": Peak(756e12, 756e12, 378e12, 51e12, 2.0e12),
    "NVIDIA H100 NVL": Peak(835e12, 835e12, 418e12, 60e12, 3.9e12),
    "NVIDIA H200": Peak(989e12, 989e12, 495e12, 67e12, 4.8e12),
}


class UnknownCard(LookupError):
    """No published peak is on record for the card."""


def peak(name: str) -> Peak:
    """The published rates of the card ``name``: a device name, or the line
    ``nvidia-smi --query-gpu=name,...`` prints, whose first field is one.
    A card not in :data:`PEAKS` raises :class:`UnknownCard`."""
    card = name.split(",")[0].strip()
    if card not in PEAKS:
        raise UnknownCard(f"no published peak on record for the card {card!r}")
    return PEAKS[card]


def hbm_bytes_per_s(name: str) -> float:
    """Published HBM rate of the card ``name`` (see :func:`peak`)."""
    return peak(name).hbm_bytes_per_s


_ACTIVE: list = []  # the counters inside whose block this process runs


class FlopCounter(FlopCounterMode):
    """``FlopCounterMode`` under the convention above.

    Counts by module path (``TCStereo.update_block.encoder``, with
    ``Global`` for the whole) and by op; an op that runs inside autograd's
    backward is counted under the phase ``"backward"``, every other under
    ``"forward"``. The module paths are the forward's: inside the backward
    torch's module tracker does not say reliably which module a gradient op
    serves. ``own`` holds each count under its innermost module alone. The
    hand entries add their taps through :func:`counted` and count nothing
    inside.
    """

    def __init__(self):
        super().__init__(display=False)
        self._inside = 0
        self.own: Dict[str, Dict[Tuple[str, str], int]] = defaultdict(lambda: defaultdict(int))

    def __enter__(self):
        super().__enter__()
        self.own.clear()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *args):
        _ACTIVE.remove(self)
        return super().__exit__(*args)

    def _count_flops(self, func_packet, out, args, kwargs):
        if not self._inside and func_packet in self.flop_registry:
            self.add(str(func_packet), self.flop_registry[func_packet](*args, **kwargs,
                                                                       out_val=out))
        return out

    def add(self, op: str, flops: int) -> None:
        """Count ``flops`` under ``op`` at every module the call runs in."""
        phase = "backward" if self.mod_tracker.is_bw else "forward"
        parents = set(self.mod_tracker.parents)
        for path in parents:
            self.flop_counts[path][op, phase] += int(flops)
        # The innermost module: the parents are one chain of paths.
        self.own[max(parents, key=lambda p: (p != "Global", p.count(".")))][op, phase] += int(flops)

    @contextlib.contextmanager
    def opaque(self):
        """Inside the block no op is counted: a hand entry's own ops."""
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    @property
    def total(self) -> int:
        return self.get_total_flops()

    def by_op(self, phase: Optional[str] = None) -> Dict[str, int]:
        """FLOPs of each op, of one phase or both summed."""
        out: Dict[str, int] = defaultdict(int)
        for (op, ph), n in self.flop_counts["Global"].items():
            if phase in (None, ph):
                out[op] += n
        return dict(out)

    def phase(self, phase: str) -> int:
        return sum(self.by_op(phase).values())

    def by_module(self, phase: Optional[str] = None) -> Dict[str, int]:
        """FLOPs under each module path, its children's included (``Global``
        is the whole)."""
        return {path: sum(n for (_, ph), n in ops.items() if phase in (None, ph))
                for path, ops in self.flop_counts.items()}

    def table(self, depth: int = 2) -> str:
        """Every op's GFLOP in each phase, then the forward's by module path to
        ``depth`` below the root. (Inside autograd's backward, torch's module
        tracker does not say reliably which module a gradient op serves.)"""
        lines = [f"{'Global':<48} {self.total / 1e9:14.3f} GFLOP"]
        for (op, ph), n in sorted(self.flop_counts["Global"].items()):
            lines.append(f"  {ph:<8} {op:<38} {n / 1e9:14.3f}")
        for path, n in sorted(self.by_module("forward").items()):
            if path != "Global" and path.count(".") < depth:
                lines.append(f"{path:<48} {n / 1e9:14.3f} GFLOP forward")
        return "\n".join(lines)


def counted(op: str, taps: Callable[..., int],
            differentiable: Callable[..., Sequence]) -> Callable:
    """Decorate a hand entry: inside a :class:`FlopCounter` a call counts
    2 × ``taps(*args)`` under ``op`` and nothing inside the call; its
    backward counts as much again for each input in ``differentiable(*args)``
    (a tensor, or a sequence of tensors taken as one input) that requires a
    gradient. Outside a counter the entry runs as it is."""

    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            counter = _ACTIVE[-1]
            flops = 2 * taps(*args, **kwargs)
            counter.add(op, flops)
            with counter.opaque():
                out = fn(*args, **kwargs)
            grads = sum(any(t.requires_grad for t in
                            ((x,) if isinstance(x, torch.Tensor) else x))
                        for x in differentiable(*args, **kwargs))
            if grads and out.requires_grad:
                def backward_taps(grad):
                    if counter in _ACTIVE:
                        counter.add(op, grads * flops)

                out.register_hook(backward_taps)
            return out

        return entry

    return wrap


def _camera(B: int, H: int, W: int, device):
    from tcs_tpu_torch.models import CameraParams

    K = torch.tensor([[721.5, 0, W / 2], [0, 721.5, H / 2], [0, 0, 1]], device=device)
    return CameraParams(K=K.expand(B, 3, 3).contiguous(),
                        baseline=torch.full((B,), 0.54, device=device))


def inference_flops(cfg, height: int, width: int, iters: int, batch: int = 1,
                    device=None) -> FlopCounter:
    """The count of one streaming frame with the state carried (the warp
    path, as every frame after the first runs), test mode, of ``cfg`` at
    ``height`` × ``width``. Runs the model once on ``device`` (the card by
    default; ``"cpu"`` runs the plain versions, with the same count)."""
    from tcs_tpu_torch import device as device_lib
    from tcs_tpu_torch.models import TCStereo, TemporalState

    dev = device_lib.resolve(device)
    model = TCStereo(cfg, device=dev, seed=0)
    state = dataclasses.replace(
        TemporalState.zeros(batch, height, width, cfg, device=dev), valid=True)
    images = torch.zeros(batch, height, width, 3, device=dev)
    pose = torch.eye(4, device=dev).expand(batch, 4, 4).contiguous()
    with FlopCounter() as counter:
        model(images, images, state, _camera(batch, height, width, dev), pose, iters=iters)
    return counter


def train_step_flops(train_cfg, device=None) -> Tuple[FlopCounter, dict]:
    """The count of one ``make_train_step`` step of the recipe ``train_cfg``
    (its batch, crop, window and iterations) on a synthetic batch, and the
    step's metrics. Runs the step once on ``device`` (the card by default)."""
    from tcs_tpu_torch import device as device_lib
    from tcs_tpu_torch.data.synthetic import make_clips
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.train import SequenceBatch, make_train_step

    dev = device_lib.resolve(device)
    H, W = train_cfg.image_size
    model = TCStereo(train_cfg.model, device=dev, seed=0)
    step = make_train_step(model, train_cfg)
    batch = SequenceBatch.from_numpy(make_clips(train_cfg.batch_size, H, W,
                                                train_cfg.frame_length, train_cfg.seed), dev)
    with FlopCounter() as counter:
        metrics = step(batch)
    return counter, metrics
