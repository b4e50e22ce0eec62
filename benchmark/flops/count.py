"""The benchmark's own FLOP count, worked out from a cell's shapes.

The convention (the one ``tcs_tpu_torch/utils/flops.py`` states, counted
here by other code): 2 × the multiply-adds of the function the model
computes, whatever implements it.

- Convolutions and matrix products as ``torch.utils.flop_counter`` counts
  them (a transposed convolution over its input; a convolution's backward as
  one forward convolution for each gradient taken); the cost volume is one
  product.
- The radius lookup, the splat and the convex upsample by their taps, one
  multiply-add a tap, at their entries and nothing inside them: the lookup
  4 FLOPs an output element, the splat 8 a payload element, the convex
  upsample 18·f² a low-resolution element. In the backward each counts its
  forward again for every input that takes a gradient.
- Left out: pools, norms, activations, gates, losses, the optimiser and every
  other elementwise operation.

The count runs the frozen reference (``benchmark/reference``) on the
``meta`` device, so it costs no device time and no memory, and takes the
splat's output shape alone (its scatter's indices are data). A step counts
its forward, losses and backward. Bootstrap and carried frames differ
(argmax against warp) and are counted as what they are.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import losses, ops
from benchmark.reference.model import Arch, State, TCStereo

META = torch.device("meta")


@dataclasses.dataclass
class Flops:
    """A call's FLOPs: ``dense`` the convolutions and products, ``taps`` the
    lookup, splat and upsample taps by entry; ``total`` the two."""

    dense: int = 0
    taps: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total(self) -> int:
        return self.dense + sum(self.taps.values())

    def __add__(self, other: "Flops") -> "Flops":
        taps = dict(self.taps)
        for k, v in other.taps.items():
            taps[k] = taps.get(k, 0) + v
        return Flops(self.dense + other.dense, taps)

    def __mul__(self, n: int) -> "Flops":
        return Flops(self.dense * n, {k: v * n for k, v in self.taps.items()})


class _Counter(FlopCounterMode):
    """``FlopCounterMode`` that counts nothing inside a tap entry."""

    def __init__(self):
        super().__init__(display=False)
        self.inside = 0
        self.taps: Dict[str, int] = {}

    def _count_flops(self, func_packet, out, args, kwargs):
        if self.inside:
            return out
        return super()._count_flops(func_packet, out, args, kwargs)

    def add_taps(self, name: str, n: int) -> None:
        self.taps[name] = self.taps.get(name, 0) + int(n)


def _entry(counter: _Counter, name: str, fn, flops_of, inputs_of):
    def wrapped(*args):
        flops = flops_of(*args)
        counter.add_taps(name, flops)
        counter.inside += 1
        try:
            out = fn(*args)
        finally:
            counter.inside -= 1
        grads = sum(any(t.requires_grad for t in (x if isinstance(x, (tuple, list)) else (x,)))
                    for x in inputs_of(*args))
        if grads and out.requires_grad:
            out.register_hook(lambda g: counter.add_taps(name, grads * flops))
        return out

    return wrapped


def _splat_shape(values, flow):
    return torch.zeros_like(values)  # the scatter's targets are data; under no_grad


@contextlib.contextmanager
def counting():
    """Count inside the block; yields the counter. The reference's three tap
    entries are wrapped for the block's duration."""
    counter = _Counter()
    saved = ops.lookup, ops.splat_sum, ops.convex_upsample_nchw
    ops.lookup = _entry(counter, "lookup", saved[0],
                        lambda pyr, c, r: 4 * c.numel() * len(pyr) * (2 * r + 1),
                        lambda pyr, c, r: (tuple(pyr),))
    ops.splat_sum = _entry(counter, "splat", _splat_shape,
                           lambda v, f: 8 * v.numel(), lambda v, f: (v, f))
    ops.convex_upsample_nchw = _entry(counter, "convex_upsample", saved[2],
                                      lambda fld, m, f: 18 * f * f * fld.numel(),
                                      lambda fld, m, f: (fld, m))
    try:
        with counter:
            yield counter
    finally:
        ops.lookup, ops.splat_sum, ops.convex_upsample_nchw = saved


def _result(counter: _Counter) -> Flops:
    return Flops(int(counter.get_total_flops()), dict(counter.taps))


def _camera(B: int, H: int, W: int):
    K = torch.tensor([[721.5, 0, W / 2], [0, 721.5, H / 2], [0, 0, 1]], device=META)
    return K.expand(B, 3, 3), torch.full((B,), 0.54, device=META)


def frame(arch: Arch, batch: int, height: int, width: int, iters: int,
          carried: bool) -> Flops:
    """One streaming frame (test mode) at the padded size: the bootstrap
    (``carried=False``) or a frame with the state carried."""
    with torch.device(META):
        net = TCStereo(arch)
    state = dataclasses.replace(State.zeros(batch, height, width, arch, META), valid=carried)
    img = torch.zeros(batch, height, width, 3, device=META)
    K, b = _camera(batch, height, width)
    pose = torch.eye(4, device=META).expand(batch, 4, 4)
    with counting() as c:
        net(img, img, state, K, b, pose, iters)
    return _result(c)


def train_step(arch: Arch, recipe: dict, batch: int, height: int, width: int,
               frames: int) -> Flops:
    """One training step of the window: every frame's train-mode forward, its
    losses and its backward; the first frame bootstraps, the others carry."""
    with torch.device(META):
        net = TCStereo(arch)
    state = State.zeros(batch, height, width, arch, META)
    img = torch.zeros(batch, height, width, 3, device=META)
    flow = torch.zeros(batch, height, width, 1, device=META)
    K, b = _camera(batch, height, width)
    pose = torch.eye(4, device=META).expand(batch, 4, 4)
    with counting() as c:
        for _ in range(frames):
            out = net(img, img, state, K, b, pose, recipe["train_iters"], train=True)
            (losses.frame_loss(out, flow, torch.ones_like(flow), recipe) / frames).backward()
            state = out.state
    return _result(c)


def stream_call(arch: Arch, batch: int, height: int, width: int, iters: int
                ) -> Tuple[Flops, Flops]:
    """(bootstrap, carried) FLOPs of one call of ``batch`` streams."""
    return (frame(arch, batch, height, width, iters, False),
            frame(arch, batch, height, width, iters, True))
