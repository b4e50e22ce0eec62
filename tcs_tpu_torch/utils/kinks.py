"""Pin the ReLU kinks of a run, to compare the gradients of two runs.

A ReLU or leaky ReLU unit whose pre-activation is within rounding of zero
falls on one side of its kink in one run and on the other in the next
(another device, another library, another summation order). The forward
values hardly notice, but the unit passes its whole upstream gradient in one
run and none (or a hundredth) in the other. Among the millions of units of a
small model a few dozen do so between any two fp32 runs, and a leaf whose
gradient sums over few pixels then differs by percents of its largest entry
(``scripts/torch_grad_parity_seeds.py`` counts them). With every unit put on
the side the other run took, what is left is the rounding of the arithmetic,
and a gradient check can be held to a tight bound. The witness to hold an
fp32 run against is a float64 run of the same code (:func:`widened`) with the
fp32 run's kinks pinned to its sides.

The losses' L1 terms have a kink of the same kind at a residual of zero
(``losses.l1``): a residual within rounding of zero sends its gradient with
one sign in one run and with the other in the next. ``Kinks(l1=True)`` pins
those too.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


class Kinks:
    """Context manager that stands in for ``F.relu`` and ``F.leaky_relu``,
    and with ``l1`` for ``losses.l1`` (|r| as r·(±1)).

    It records on which side of its kink every unit falls, call by call
    (``sides``, boolean CPU tensors), and, given another run's record as
    ``replay``, puts every unit on the side that run took. Values and
    gradients without ``replay`` are those of the functions it stands in for.
    """

    def __init__(self, replay=None, l1: bool = False):
        self.sides, self.replay, self.l1 = [], replay, l1

    def _apply(self, x, slope):
        side = x > 0
        self.sides.append(side.cpu())
        if self.replay is not None:
            side = self.replay[len(self.sides) - 1].to(x.device)
        return x * torch.where(side, 1.0, slope).to(x.dtype)

    def __enter__(self):
        from tcs_tpu_torch import losses

        self._saved = F.relu, F.leaky_relu, losses.l1
        F.relu = lambda x, inplace=False: self._apply(x, 0.0)
        F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: self._apply(
            x, negative_slope)
        if self.l1:
            losses.l1 = lambda r: self._apply(r, -1.0)
        return self

    def __exit__(self, *exc):
        from tcs_tpu_torch import losses

        F.relu, F.leaky_relu, losses.l1 = self._saved

    def crossed(self, other) -> int:
        """Units that fall on another side than in ``other``, a ``sides`` record."""
        return sum(int((a != b).sum()) for a, b in zip(self.sides, other))


@contextlib.contextmanager
def widened():
    """Inside the block ``Tensor.float()`` widens to float64, so a model set
    to float64 keeps that width through the port's explicit fp32 casts."""
    saved = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = saved
