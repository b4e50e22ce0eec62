"""Forward softmax splatting (port of ``tcs_tpu/ops/splat.py``).

``splat_sum`` is the bilinear forward scatter-add. On a CUDA tensor it
launches the hand-written ``csrc/softsplat.cu`` kernel, a gather with no
float atomics: it sums each target cell's contributions in (tap, source
index) order, as ``tcs_tpu``'s XLA scatter and :func:`splat_sum_plain`
(``index_add_``, which the CPU tensors run) do. So the kernel is
deterministic and agrees with the plain version on the CPU bit for bit.

``splat_sum`` is a ``torch.autograd.Function``. Its backward, a four-tap
bilinear gather of the output cotangent (the math of ``splat_sum_gatherbwd``
in the JAX package), launches ``csrc/softsplat_bwd.cu`` on a CUDA tensor and
runs :func:`splat_sum_bwd_plain` on a CPU tensor. ``softsplat``'s own
arithmetic around it differentiates by autograd.
"""

from __future__ import annotations

import torch

from tcs_tpu_torch.ops import _kernels
from tcs_tpu_torch.utils import flops

_EPS = 1e-7
_TAPS = ((0, 0), (1, 0), (0, 1), (1, 1))


def splat_sum_plain(values: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear forward scatter-add of ``values`` along ``flow``.

    Each source pixel (x, y) adds ``values[b, y, x]`` to the four integer
    neighbours of (x + flow_x, y + flow_y) with weight
    (1 − |tx − xi|)(1 − |ty − yi|). Taps outside the image are dropped and
    non-finite targets skipped (reference kernel ``softsplat.py:301-302``).
    On the CPU, ``index_add_`` adds one tap's rows after another, each in
    source order: every target cell sums its contributions in (tap, source
    index) order, each product rounded before its add, as ``tcs_tpu``'s
    scatter does and the kernel does. (On a CUDA tensor ``index_add_`` adds
    with atomics, in no fixed order.)

    values: (B, H, W, C), flow: (B, H, W, 2) → (B, H, W, C).
    """
    B, H, W, C = values.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=values.dtype, device=values.device),
                            torch.arange(W, dtype=values.dtype, device=values.device),
                            indexing="ij")
    tx = xs + flow[..., 0]
    ty = ys + flow[..., 1]
    finite = torch.isfinite(tx) & torch.isfinite(ty)
    tx = torch.where(finite, tx, torch.full_like(tx, -10.0))
    ty = torch.where(finite, ty, torch.full_like(ty, -10.0))
    x0, y0 = torch.floor(tx), torch.floor(ty)
    out = values.new_zeros(B * H * W, C)
    src = values.reshape(B * H * W, C)
    boff = (torch.arange(B, device=values.device) * (H * W))[:, None, None]
    for dx, dy in _TAPS:
        xi, yi = x0 + dx, y0 + dy
        w = (1.0 - (tx - xi).abs()) * (1.0 - (ty - yi).abs())
        valid = ((xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)).reshape(-1)
        idx = (boff + yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long())
        idx = idx.reshape(-1)
        out.index_add_(0, idx[valid], (src * w.reshape(-1, 1))[valid])
    return out.reshape(B, H, W, C)


def splat_sum_bwd_plain(g: torch.Tensor, values: torch.Tensor,
                        flow: torch.Tensor):
    """Backward of :func:`splat_sum_plain` (``_splat_gatherbwd_bwd`` of the
    JAX package): the adjoint of the bilinear scatter is a bilinear gather.

    Each source pixel reads ``g`` at the four integer neighbours of its
    target: ``dvalues = Σ wx·wy·g_tap``, and the same taps contracted with
    ``values`` and the weight derivatives (−1 at the floor tap, +1 at the
    floor + 1 tap) give ``dflow``. Taps outside the image contribute nothing;
    a non-finite target gives zero gradients.

    g, values: (B, H, W, C), flow: (B, H, W, 2) → dvalues (B, H, W, C),
    dflow (B, H, W, 2).
    """
    B, H, W, C = values.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=values.dtype, device=values.device),
                            torch.arange(W, dtype=values.dtype, device=values.device),
                            indexing="ij")
    tx = xs + flow[..., 0]
    ty = ys + flow[..., 1]
    finite = torch.isfinite(tx) & torch.isfinite(ty)
    tx = torch.where(finite, tx, torch.full_like(tx, -10.0))
    ty = torch.where(finite, ty, torch.full_like(ty, -10.0))
    x0, y0 = torch.floor(tx), torch.floor(ty)
    gflat = g.reshape(B, H * W, C)
    dvalues = torch.zeros_like(values)
    dtx = torch.zeros_like(tx)
    dty = torch.zeros_like(ty)
    for dx, dy in _TAPS:
        xi, yi = x0 + dx, y0 + dy
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        lin = (yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long())
        gval = torch.gather(gflat, 1, lin.reshape(B, H * W, 1).expand(-1, -1, C))
        gval = gval.reshape(B, H, W, C) * valid[..., None].to(values.dtype)
        wx = 1.0 - (tx - xi).abs()
        wy = 1.0 - (ty - yi).abs()
        dvalues = dvalues + (wx * wy)[..., None] * gval
        dot = torch.sum(values * gval, dim=-1)
        dtx = dtx + (1.0 if dx else -1.0) * wy * dot
        dty = dty + wx * (1.0 if dy else -1.0) * dot
    dflow = torch.stack([dtx, dty], dim=-1) * finite[..., None].to(values.dtype)
    return dvalues, dflow


def _check_splat_args(values, flow):
    if values.device.type != "cuda" or flow.device != values.device:
        raise ValueError(f"splat_sum: values on {values.device}, flow on "
                         f"{flow.device}; both must be on one CUDA device or the CPU")
    if values.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError("splat_sum kernel takes fp32 values and flow")
    if values.dim() != 4 or flow.shape != (*values.shape[:3], 2):
        raise ValueError(f"splat_sum: values {tuple(values.shape)} and flow "
                         f"{tuple(flow.shape)} must be (B,H,W,C) and (B,H,W,2)")
    if 4 * values.shape[:3].numel() > 2**31 - 1:
        raise ValueError(f"splat_sum kernel: (B, H, W) {tuple(values.shape[:3])} holds "
                         f"2^29 pixels or more, past its int32 bucket keys")
    if not (values.is_contiguous() and flow.is_contiguous()):
        raise ValueError("splat_sum kernel takes contiguous tensors")


def _launch_splat_sum(values, flow):
    """One call of ``csrc/softsplat.cu``: five launches (a zero fill of the
    counts, count, scan, fill, gather), counted as one. The tensors carry no
    autograd history here: :class:`_SplatSum` is the only caller."""
    _check_splat_args(values, flow)
    B, H, W, C = values.shape
    out = torch.empty_like(values)
    lib = _kernels.lib()
    scratch = torch.empty(lib.tcs_splat_sum_scratch_ints(B * H * W), dtype=torch.int32,
                          device=values.device)
    with torch.cuda.device(values.device):
        err = lib.tcs_splat_sum(values.data_ptr(), flow.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), B, H, W, C,
                                torch.cuda.current_stream().cuda_stream)
    _kernels.check(err, "splat_sum")
    _kernels.launches["splat_sum"] += 1
    return out


def _launch_splat_sum_bwd(g, values, flow):
    """One launch of ``csrc/softsplat_bwd.cu``: (dvalues, dflow)."""
    if g.device != values.device or g.dtype != torch.float32 \
            or g.shape != values.shape:
        raise ValueError(f"splat_sum backward: cotangent {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    g = g.contiguous()
    B, H, W, C = values.shape
    dvalues = torch.empty_like(values)
    dflow = torch.empty_like(flow)
    lib = _kernels.lib()
    with torch.cuda.device(values.device):
        err = lib.tcs_splat_sum_bwd(g.data_ptr(), values.data_ptr(), flow.data_ptr(),
                                    dvalues.data_ptr(), dflow.data_ptr(), B, H, W, C,
                                    torch.cuda.current_stream().cuda_stream)
    _kernels.check(err, "splat_sum_bwd")
    _kernels.launches["splat_sum_bwd"] += 1
    return dvalues, dflow


class _SplatSum(torch.autograd.Function):
    """The bilinear scatter-add and its hand-written gather backward."""

    @staticmethod
    def forward(ctx, values, flow):
        ctx.on_cpu = values.device.type == "cpu" and flow.device.type == "cpu"
        ctx.save_for_backward(values, flow)
        if ctx.on_cpu:
            return splat_sum_plain(values, flow)
        return _launch_splat_sum(values, flow)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        values, flow = ctx.saved_tensors
        fn = splat_sum_bwd_plain if ctx.on_cpu else _launch_splat_sum_bwd
        return fn(g, values, flow)


@flops.counted("splat_sum", lambda values, flow: 4 * values.numel(),
               lambda values, flow: (values, flow))
def splat_sum(values: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """:func:`splat_sum_plain`'s contract; the CUDA kernels on CUDA tensors.
    Differentiable with respect to the values and the flow."""
    return _SplatSum.apply(values, flow)


def softsplat(values: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor,
              valid_mask=None):
    """Softmax splatting, mode ``'soft-clipeps'`` (reference ``softsplat.py:232``).

    The only mode the model uses (reference ``geo_utils.py:196``). Splats
    ``[values·e^metric·valid, e^metric·valid]`` in one pass, divides by
    clip(weight, 1e-7) and returns (warped (B,H,W,C), mask (B,H,W,1)) with
    mask = (weight ≠ 0) taken before the clip.
    """
    if valid_mask is None:
        valid_mask = torch.ones_like(values[..., :1])
    values = values * valid_mask
    weight = torch.exp(metric)
    out = splat_sum(torch.cat([values * weight, weight * valid_mask], dim=-1)
                    .contiguous(), flow.contiguous())
    norm = out[..., -1:]
    mask = (norm != 0).to(values.dtype)
    return out[..., :-1] / norm.clamp(min=_EPS), mask
