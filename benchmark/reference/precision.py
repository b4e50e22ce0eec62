"""The reference's precision modes.

``"fp32"`` is the reference: every operation in fp32, with TF32 off
(:func:`fp32_matmuls`). ``"fp8"`` is the control that must come out as not
correct: the configurations state bf16 convolution stacks and a bf16
correlation pyramid, and the nearest precision below bf16 is fp8. In it
every convolution's input, weight and output, the outputs of the residual,
gated and GRU blocks (the activations and hidden states the stacks hold),
and each pyramid level are rounded to float8 e4m3 with one scale per tensor
(its largest magnitude mapped to e4m3's largest finite value, 448), as conv
stacks kept in fp8 hold them; products, sums and the elementwise work inside
a block stay fp32. The rounding passes gradients straight
through, so a training step computes its backward from the rounded
operands that the forward saved.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("fp32", "fp8")
_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / _E4M3_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def round_operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    """A tensor that enters or leaves a convolution (input, weight, output),
    or a pyramid level, as ``mode`` keeps it."""
    if mode == "fp32":
        return x
    if mode == "fp8":
        return _fp8(x)
    raise ValueError(f"precision {mode!r}: one of {MODES}")




@contextlib.contextmanager
def fp32_matmuls():
    """fp32 convolutions and products in full fp32 (TF32 off) inside the
    block; both switches are put back on the way out."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
