#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit, torch/CUDA versions, and the
   build of the hand-written kernels from ``tcs_tpu_torch/csrc``;
2. kernel checks: each kernel against its plain PyTorch version on the card,
   with times (CUDA events; the L2 warm, and cold after a 128 MB write), the
   card's launch floor, bounds and library yardsticks: both lookup kernels at
   the inference path's shapes (batch 1, 96×320 grid) and at the training
   path's (batch 4, 80×180 grid) for fp32 and bf16 pyramids, with non-finite
   and far-out coordinates; the splat at both shapes, its backward at the
   training path's;
3. small-model parity: the fp32 config at 64×96 for 3 frames, on the card
   with the kernels and on the CPU with the plain versions, same weights;
4. main path: ``TemporalEvaluator`` over the default config (bf16 conv
   stacks, bf16 pyramid) at 384×1280, iters 5, 12 frames with a moving pose,
   with the kernels' launch counts read around it;
5. op-level gradients: ``softsplat`` and ``lookup`` through their public
   entry points on inputs that require gradients, against autograd through
   the plain versions (this path launches the splat's backward kernel), and
   ``pool2x`` on a channel-last hidden state against the CPU;
6. small-model gradient parity: the fp32 config at 64×96, 2 frames, 2
   iterations: loss and the gradients of a few leaves, card with kernels
   against CPU with plain versions, as the model runs and with the ReLU
   kinks pinned to the CPU run's sides;
7. training path: ``make_train_step`` over the default config at the
   SceneFlow recipe's shapes (batch 4, 320×720, 2 frames, 5 iterations) on a
   synthetic batch from a seed: 1 warm-up step and 3 timed steps, with the
   launch counts read around them.

The last line of standard output is the JSON device record. Run from the
repository root: ``python chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_H, MAIN_W, MAIN_ITERS, MAIN_FRAMES = 384, 1280, 5, 12
SMALL_H, SMALL_W, SMALL_ITERS, SMALL_FRAMES = 64, 96, 2, 3
FLOW_TOL = 5e-2  # px; the bound the CPU tests hold the port to against tcs_tpu
LOOKUP_TOL = {"float32": 1e-5, "bfloat16": 1e-6}
SPLAT_RTOL = 1e-5  # of max |reference|: atomics reorder the fp32 sums
TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_FRAMES, TRAIN_ITERS = 4, 320, 720, 2, 5
TRAIN_WARM, TRAIN_TIMED = 1, 3
# Backward kernels against their plain versions, as shares of max |reference|.
LOOKUP_BWD_RTOL = {"float32": 1e-6,  # same fp32 products and sum, no FMA
                   "bfloat16": 2.0 ** -7}  # one bf16 ulp at the largest entry
SPLAT_BWD_DVALUES_RTOL = 1e-6  # same products, summed in the same order
SPLAT_BWD_DFLOW_RTOL = 1e-4  # a warp reduces the 258-channel dot products in another order
OP_GRAD_RTOL = 1e-4  # kernels against autograd through the plain versions (atomics there)
SMALL_LOSS_RTOL = 1e-3
# Card against CPU, of a leaf's largest entry, for every parameter, with every
# ReLU unit on the side of its kink that the CPU run took: rounding only
# (measured 7e-5 on the worst leaf; a pooling backward that was wrong on the
# card read 5e-3 to 3e-1).
SMALL_GRAD_RTOL = 1e-3
# The named leaves as the model runs. Over six seed pairs the card and the CPU
# are up to 1.8e-2 apart on them (scripts/torch_grad_parity_seeds.py; 4e-3 on
# this phase's pair), each a few crossed kinks from a float64 run.
SMALL_GRAD_RTOL_FREE = 3e-2
SMALL_GRAD_LEAVES = ("cnet.conv1.weight", "update_block.gru08.convzr.weight",
                     "disp_completor.conv_disp_stem.0.weight", "disp_refine.mask.2.weight")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def hbm_bytes_per_s(name: str) -> float:
    """Published HBM rate of the card (NVIDIA data sheets)."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name:
        return 3.35e12
    if "H200" in name:
        return 4.8e12
    fail(f"no HBM rate on record for {name!r}")


@contextlib.contextmanager
def tf32_off():
    """fp32 convolutions and matrix products in full fp32 inside the block;
    both flags are put back as they were."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _behind_sleep(enqueue) -> bool:
    """Run ``enqueue``, which queues work on the device, behind a device-side
    sleep that outlasts its host work, so that the device runs the queued
    work back to back and CUDA events inside it time the device, not the
    Python wrappers. A dry run gives the host time; the sleep is lengthened
    until it was still running when ``enqueue`` returned. Returns whether it
    was: a function that synchronises inside (boolean-mask indexing) cannot
    queue ahead, and then its times include its host work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enqueue()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for attempt in range(3):
        asleep = torch.cuda.Event()
        torch.cuda._sleep(int((2 * host_s * 4 ** attempt + 1e-3) * 2e9))  # cycles at ~2 GHz
        asleep.record()
        enqueue()
        ahead = not asleep.query()
        torch.cuda.synchronize()
        if ahead:
            return True
    return False


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls, the
    L2 warm: the inputs stay in the 50 MB L2 from one call to the next. The
    calls are queued ahead of the device (:func:`_behind_sleep`)."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def enqueue():
        start.record()
        for _ in range(reps):
            fn()
        stop.record()

    if not _behind_sleep(enqueue):
        print("  (the device waited on the host: this time includes host work)")
    return start.elapsed_time(stop) / reps


COLD_FLUSH_BYTES = 128 * 2**20  # written before each cold call: 2.5x the L2


def cuda_cold_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` in ms with the L2 cold, as the
    model leaves it between two lookups: before each call a 128 MB buffer is
    written, and one pair of CUDA events brackets the call alone. The calls
    are queued ahead of the device (:func:`_behind_sleep`)."""
    flush = torch.empty(COLD_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        flush.zero_()
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]

    def enqueue():
        for start, stop in events:
            flush.zero_()
            start.record()
            fn()
            stop.record()

    if not _behind_sleep(enqueue):
        print("  (the device waited on the host: this time includes host work)")
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def launch_floor() -> dict:
    """The card's cost of one launch: an empty kernel (``torch.cuda._sleep(0)``)
    timed as :func:`cuda_ms` and :func:`cuda_cold_ms` time a kernel."""
    fn = lambda: torch.cuda._sleep(0)  # noqa: E731
    rec = dict(ms=cuda_ms(fn, reps=200), cold_ms=cuda_cold_ms(fn, reps=50))
    print(f"launch floor (torch.cuda._sleep(0)): back-to-back {rec['ms']:.4f} ms, "
          f"one launch bracketed by events after an L2 flush {rec['cold_ms']:.4f} ms")
    return rec


def phase_device():
    from tcs_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _kernels.lib()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_kernels.build_seconds} s)")
    os.makedirs("runs", exist_ok=True)
    with open("runs/nvcc_build.log", "w") as f:
        f.write(_kernels.build_log)
    print(f"ptxas: {ptxas_summary(_kernels.build_log)} (runs/nvcc_build.log has each)")
    return smi


def ptxas_summary(log: str) -> str:
    """Entry functions, the most registers any uses, and the spill bytes of
    ``nvcc -Xptxas -v``'s output."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
    return (f"{len(re.findall('Compiling entry function', log))} entry functions, "
            f"at most {max(regs, default=0)} registers, {spills} bytes of spills")


def _bad_flow(B, h, w, g, dev):
    """A (B, h, w, 2) flow, mostly small, with some targets out of the image
    and some non-finite."""
    flow = (torch.randn(B, h, w, 2, generator=g) * 3.0).to(dev)
    flow[:, :, :8, 0] = -30.0
    flow[:, :4, :, 1] = 1e4
    flow[:, 50, 100:140, 0] = float("nan")
    flow[:, 60, 10:20, 1] = float("inf")
    return flow


def _random_pyramid(B, h, w, L, g, dev):
    """An fp32 correlation pyramid of random features, (B, h, w, w >> i)."""
    from tcs_tpu_torch.ops import corr

    f1 = torch.randn(B, h, w, 64, generator=g).to(dev)
    f2 = torch.randn(B, h, w, 64, generator=g).to(dev)
    return tuple(p.contiguous() for p in corr.corr_pyramid(corr.build_cost_volume(f1, f2), L))


def grid_sample_lookup(pyr, coords, r):
    """The lookup as the library computes it: per level one
    ``F.grid_sample`` of the rows (rows, 1, 1, W2ᵢ) at the 2r+1 window
    positions (grid (rows, 1, 2r+1, 2), ``align_corners=True``, zero padding),
    then the concatenation. The port never calls it: it is the yardstick of
    the lookup rows. Returns the function of the levels and ``pyr``'s rows as
    its levels. The grid is in the levels' type, as ``grid_sample`` requires,
    so in bf16 its positions round; non-finite coordinates become far-out
    ones."""
    import torch.nn.functional as F

    rows = coords.numel()
    k = torch.arange(-r, r + 1, device=coords.device, dtype=torch.float32)
    finite = torch.where(torch.isfinite(coords), coords, -1e20).reshape(rows, 1)
    grids = []
    for i, p in enumerate(pyr):
        x = finite / 2 ** i + k
        gx = 2 * x / (p.shape[-1] - 1) - 1
        grids.append(torch.stack([gx, torch.zeros_like(gx)], -1)
                     .reshape(rows, 1, 2 * r + 1, 2).to(p.dtype).contiguous())

    def fn(levels):
        return torch.cat([F.grid_sample(x, gd, mode="bilinear", padding_mode="zeros",
                                        align_corners=True).reshape(rows, 2 * r + 1)
                          for x, gd in zip(levels, grids)], dim=-1)

    return fn, [p.reshape(rows, 1, 1, p.shape[-1]) for p in pyr]


def _lookup_bytes(pyr, coords, r) -> int:
    """Bytes the lookup must move: the in-range window taps this run's
    coordinates select, the coordinates, and the fp32 output."""
    taps = 0
    for i, p in enumerate(pyr):
        base = torch.floor(coords / 2 ** i)[..., None] + torch.arange(
            -r, r + 2, device=coords.device)
        taps += int(((base >= 0) & (base <= p.shape[-1] - 1)).sum())
    return (taps * pyr[0].element_size() + coords.numel() * 4
            + coords.numel() * len(pyr) * (2 * r + 1) * 4)


def check_lookup(tag, pyr, coords, gout, r, rate) -> dict:
    """``corr.lookup`` and its backward against ``lookup_plain`` and
    ``lookup_bwd_plain`` on one pyramid, with times (warm and cold), bounds
    and the ``grid_sample`` yardstick. ``coords`` holds non-finite and far-out
    values: the forward gives NaN where the plain version does, and the
    backward a row of zeros. Returns the records of both kernels."""
    from tcs_tpu_torch.ops import corr

    name = str(pyr[0].dtype).split(".")[-1]
    dt, widths = pyr[0].dtype, [p.shape[-1] for p in pyr]
    out = corr.lookup(pyr, coords, r)
    ref = corr.lookup_plain(pyr, coords, r)
    torch.cuda.synchronize()
    nan = ref.isnan()
    err = (out[~nan] - ref[~nan]).abs().max().item()
    print(f"lookup[{tag}] max|d| = {err:.3e} (tol {LOOKUP_TOL[name]:.0e}), "
          f"{int(nan.sum())} NaN outputs where the plain version has them")
    if not torch.equal(out.isnan(), nan) or not torch.isfinite(out[~nan]).all() \
            or not err <= LOOKUP_TOL[name]:
        fail(f"lookup[{tag}] disagrees with lookup_plain: {err}")
    # Through the wrapper: the autograd function's backward launches the kernel.
    leaves = [p.clone().requires_grad_() for p in pyr]
    outs = torch.autograd.grad(corr.lookup(leaves, coords, r), leaves, gout)
    refs = corr.lookup_bwd_plain(gout, coords, r, widths, dt)
    torch.cuda.synchronize()
    scale = max(x.float().abs().max().item() for x in refs)
    berr = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs, refs))
    btol = LOOKUP_BWD_RTOL[name] * scale
    print(f"lookup_bwd[{tag}] max|d| = {berr:.3e} (tol {btol:.3e} = "
          f"{LOOKUP_BWD_RTOL[name]:.1e} x {scale:.3e})")
    if not all(torch.isfinite(a.float()).all() for a in outs) or not berr <= btol:
        fail(f"lookup_bwd[{tag}] disagrees with lookup_bwd_plain: {berr}")
    bad = ~torch.isfinite(coords) | (coords.abs() > 1e10)
    if any(a[bad].any() for a in outs):
        fail(f"lookup_bwd[{tag}]: a non-finite or far-out coordinate did not give a row of zeros")

    fwd = dict(max_abs_err=err, ms=cuda_ms(lambda: corr.lookup(pyr, coords, r)),
               cold_ms=cuda_cold_ms(lambda: corr.lookup(pyr, coords, r)),
               plain_ms=cuda_ms(lambda: corr.lookup_plain(pyr, coords, r), reps=10),
               bound_ms=_lookup_bytes(pyr, coords, r) / rate * 1e3)
    bwd_fn = lambda: corr._launch_lookup_bwd(gout, coords, r, widths, dt)  # noqa: E731
    # Bytes: the whole gradient pyramid written once, g and coords read once.
    bbytes = (sum(a.numel() * a.element_size() for a in outs)
              + gout.numel() * 4 + coords.numel() * 4)
    bwd = dict(max_abs_err=berr, ms=cuda_ms(bwd_fn), cold_ms=cuda_cold_ms(bwd_fn),
               plain_ms=cuda_ms(lambda: corr.lookup_bwd_plain(gout, coords, r, widths, dt),
                                reps=10),
               bound_ms=bbytes / rate * 1e3)
    # Library yardstick, forward and autograd backward to the levels.
    lib_fn, lib_in = grid_sample_lookup(pyr, coords, r)
    lib_levels = [x.detach().requires_grad_() for x in lib_in]
    lib_out = lib_fn(lib_levels)
    lib_err = (lib_out.float().reshape(ref.shape)[~nan] - ref[~nan]).abs().max().item()
    fwd["library_ms"] = cuda_ms(lambda: lib_fn(lib_in))
    bwd["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        lib_out, lib_levels, gout.reshape(lib_out.shape).to(lib_out.dtype), retain_graph=True))
    for kname, rec, nbytes in (("lookup", fwd, None), ("lookup_bwd", bwd, bbytes)):
        print(f"{kname}[{tag}] kernel_ms {rec['ms']:.4f} cold_ms {rec['cold_ms']:.4f} "
              f"plain_ms {rec['plain_ms']:.4f} library_ms {rec['library_ms']:.4f} "
              f"bound_ms {rec['bound_ms']:.4f}" + (f" ({nbytes} B)" if nbytes else ""))
    print(f"lookup[{tag}] library: 4 calls of grid_sample; its max|d| against lookup_plain "
          f"{lib_err:.3e}")
    return {"lookup": fwd, "lookup_bwd": bwd}


def check_splat_forward(tag, values, flow, rate) -> dict:
    """``splat.splat_sum`` against ``splat_sum_plain``, with times (warm and
    cold), the ``index_add_`` yardstick and the bound."""
    from tcs_tpu_torch.ops import splat

    C = values.shape[-1]
    out = splat.splat_sum(values, flow)
    ref = splat.splat_sum_plain(values, flow)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    print(f"splat_sum[{tag}] max|d| = {err:.3e} (tol {SPLAT_RTOL:.0e} x {scale:.3e})")
    if not torch.isfinite(out).all() or not err <= SPLAT_RTOL * scale:
        fail(f"splat_sum[{tag}] disagrees with splat_sum_plain: {err}")
    ms = cuda_ms(lambda: splat.splat_sum(values, flow))
    cold_ms = cuda_cold_ms(lambda: splat.splat_sum(values, flow))
    plain_ms = cuda_ms(lambda: splat.splat_sum_plain(values, flow), reps=10)
    # Library yardstick: one index_add_ of the four taps' weighted rows.
    rows_i, idx, wgt = _flat_taps(flow)
    rows = values.reshape(-1, C)[rows_i] * wgt[:, None]
    acc = torch.zeros(values.numel() // C, C, device=values.device)
    library_ms = cuda_ms(lambda: acc.index_add_(0, idx, rows))
    nbytes = (values.numel() + flow.numel() + out.numel()) * 4
    print(f"splat_sum[{tag}] kernel_ms {ms:.4f} cold_ms {cold_ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {library_ms:.4f} bound_ms {nbytes / rate * 1e3:.4f} ({nbytes} B)")
    return dict(max_abs_err=err, ms=ms, cold_ms=cold_ms, plain_ms=plain_ms,
                bound_ms=nbytes / rate * 1e3, library_ms=library_ms)


# Grid of the lookup on each path: (batch, h, w) at a quarter of the image.
LOOKUP_SHAPES = {"inference": (1, MAIN_H // 4, MAIN_W // 4),
                 "training": (TRAIN_B, TRAIN_H // 4, TRAIN_W // 4)}
LOOKUP_LEVELS, LOOKUP_RADIUS = 4, 4


def lookup_inputs(shape: str, g: torch.Generator):
    """An fp32 pyramid, coordinates and an output cotangent at one path's
    shapes. The coordinates run past both ends of the rows (zero padding),
    and a few are non-finite or far out."""
    dev = torch.device("cuda")
    B, h, w = LOOKUP_SHAPES[shape]
    L, r = LOOKUP_LEVELS, LOOKUP_RADIUS
    pyr32 = _random_pyramid(B, h, w, L, g, dev)
    coords = (torch.rand(B, h, w, generator=g) * (w + 40) - 20).to(dev)
    coords[0, 0, :5] = torch.tensor([float("nan"), float("inf"), float("-inf"), 1e20, -1e20],
                                    device=dev)
    gout = torch.randn(B, h, w, L * (2 * r + 1), generator=g).to(dev)
    return pyr32, coords, gout


def lookup_records(rate: float, g: torch.Generator) -> dict:
    """Both lookup kernels against their plain versions at both paths' shapes,
    fp32 and bf16 pyramids: records by (kernel, shape, type)."""
    records = {}
    for shape, (B, h, w) in LOOKUP_SHAPES.items():
        pyr32, coords, gout = lookup_inputs(shape, g)
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            pyr = tuple(p.to(dt).contiguous() for p in pyr32)
            recs = check_lookup(f"{name}, B{B} {h}x{w}", pyr, coords, gout, LOOKUP_RADIUS, rate)
            records["corr_lookup", shape, name] = recs["lookup"]
            records["corr_lookup_bwd", shape, name] = recs["lookup_bwd"]
    return records


def phase_kernels(rate: float) -> dict:
    """Every kernel against its plain version: both lookup kernels at the
    inference path's shapes (batch 1, 96×320 grid) and at the training
    path's (batch 4, 80×180), the splat at both, its backward at the
    training path's. Records by (kernel, shape, type)."""
    from tcs_tpu_torch.ops import splat

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    records = lookup_records(rate, g)
    # Splat at the warp's payload: (B, h, w, 258) fp32.
    C = 258
    for shape, (B, h, w) in LOOKUP_SHAPES.items():
        values = torch.randn(B, h, w, C, generator=g).to(dev)
        flow = _bad_flow(B, h, w, g, dev)
        records["splat_sum", shape, "float32"] = check_splat_forward(
            f"B{B} {h}x{w}x{C}", values, flow, rate)
    tag = f"B{B} {h}x{w}x{C}"  # the training path's, the last of the loop
    gsplat = torch.randn(B, h, w, C, generator=g).to(dev)
    v, f = values.clone().requires_grad_(), flow.clone().requires_grad_()
    dv, df = torch.autograd.grad(splat.splat_sum(v, f), (v, f), gsplat)
    rdv, rdf = splat.splat_sum_bwd_plain(gsplat, values, flow)
    torch.cuda.synchronize()
    errs = {}
    for nm, a, b, rtol in (("dvalues", dv, rdv, SPLAT_BWD_DVALUES_RTOL),
                           ("dflow", df, rdf, SPLAT_BWD_DFLOW_RTOL)):
        scale = b.abs().max().item()
        errs[nm] = (a - b).abs().max().item()
        print(f"splat_sum_bwd[{tag}] {nm} max|d| = {errs[nm]:.3e} "
              f"(tol {rtol:.0e} x {scale:.3e})")
        if not torch.isfinite(a).all() or not errs[nm] <= rtol * scale:
            fail(f"splat_sum_bwd {nm} disagrees with splat_sum_bwd_plain: {errs[nm]}")
    if df[:, 50, 100:140].any() or dv[:, 60, 10:20].any():
        fail("splat_sum_bwd: a non-finite target did not give zero gradients")
    bwd_fn = lambda: splat._launch_splat_sum_bwd(gsplat, values, flow)  # noqa: E731
    ms, cold_ms = cuda_ms(bwd_fn), cuda_cold_ms(bwd_fn)
    plain_ms = cuda_ms(lambda: splat.splat_sum_bwd_plain(gsplat, values, flow), reps=10)
    # Library yardstick: autograd through one index_add of the taps' weighted
    # rows, which gives the gradient of those rows (a gather of g), not dflow.
    rows_i, tgt_i, wgt = _flat_taps(flow)
    rows = (values.reshape(-1, C)[rows_i] * wgt[:, None]).requires_grad_()
    acc = torch.zeros(B * h * w, C, device=dev).index_add(0, tgt_i, rows)
    gflat = gsplat.reshape(-1, C)
    library_ms = cuda_ms(lambda: torch.autograd.grad(acc, rows, gflat, retain_graph=True))
    nbytes = (3 * values.numel() + 2 * flow.numel()) * 4  # g, values, flow in; dvalues, dflow out
    records["splat_sum_bwd", "training", "float32"] = dict(
        max_abs_err=max(errs.values()), ms=ms, cold_ms=cold_ms, plain_ms=plain_ms,
        bound_ms=nbytes / rate * 1e3, library_ms=library_ms)
    print(f"splat_sum_bwd[{tag}] kernel_ms {ms:.4f} cold_ms {cold_ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {library_ms:.4f} (index_add backward: the rows' "
          f"gradient only) bound_ms {nbytes / rate * 1e3:.4f} ({nbytes} B)")
    return records


def _flat_taps(flow):
    """Target rows and weights of the four bilinear taps of every source
    pixel of a (B, h, w, 2) flow, flattened over the batch, invalid taps
    dropped: (source row, target row, weight), each (n,)."""
    B, h, w, _ = flow.shape
    dev = flow.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    tx, ty = xs + flow[..., 0], ys + flow[..., 1]
    fin = torch.isfinite(tx) & torch.isfinite(ty)
    x0, y0 = torch.floor(tx), torch.floor(ty)
    src = torch.arange(B * h * w, device=dev).reshape(B, h, w)
    boff = (torch.arange(B, device=dev) * (h * w)).reshape(B, 1, 1)
    rows, tgts, wgts = [], [], []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        ok = fin & (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        rows.append(src[ok])
        tgts.append((boff + yi * w + xi)[ok].long())
        wgts.append(((1 - (tx - xi).abs()) * (1 - (ty - yi).abs()))[ok])
    return torch.cat(rows), torch.cat(tgts), torch.cat(wgts)


def _camera(B, H, W, device):
    from tcs_tpu_torch.models import CameraParams

    K = torch.tensor([[721.5, 0, W / 2], [0, 721.5, H / 2], [0, 0, 1]],
                     device=device).expand(B, 3, 3).contiguous()
    return CameraParams(K=K, baseline=torch.full((B,), 0.54, device=device))


def _pose(k: int) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.01 * k
    T[2, 3] = 0.02 * k
    return T


def phase_small_parity() -> None:
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.models import TCStereo, TemporalState

    cfg = ModelConfig(mixed_precision=False, corr_dtype="float32")
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 255, (SMALL_FRAMES, 2, 1, SMALL_H, SMALL_W, 3)).astype(np.float32)
    flows = {}
    with tf32_off():
        for dev in ("cuda", "cpu"):
            model = TCStereo(cfg, device=dev, seed=1)
            state = TemporalState.zeros(1, SMALL_H, SMALL_W, cfg, device=dev)
            cam = _camera(1, SMALL_H, SMALL_W, dev)
            flows[dev] = []
            for k in range(SMALL_FRAMES):
                out = model(torch.from_numpy(frames[k, 0]).to(dev),
                            torch.from_numpy(frames[k, 1]).to(dev), state, cam,
                            torch.from_numpy(_pose(k))[None].to(dev), iters=SMALL_ITERS)
                state = out.new_state
                flows[dev].append(out.flow.cpu())
    for k in range(SMALL_FRAMES):
        d = (flows["cuda"][k] - flows["cpu"][k]).abs().max().item()
        print(f"small parity frame {k}: max|dflow| = {d:.3e} (tol {FLOW_TOL})")
        if not d <= FLOW_TOL:
            fail(f"small-model GPU/CPU parity, frame {k}: {d}")


def phase_main_path(smi: str):
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.evaluate import TemporalEvaluator
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.ops import _kernels

    cfg = ModelConfig()  # mixed precision, bf16 pyramid
    model = TCStereo(cfg, seed=0)
    ev = TemporalEvaluator(model, cfg, iters=MAIN_ITERS)
    rng = np.random.default_rng(2)
    H, W = MAIN_H, MAIN_W
    left = rng.uniform(0, 255, (MAIN_FRAMES, H, W + 64, 3)).astype(np.float32)
    K = np.array([[721.5, 0, W / 2], [0, 721.5, H / 2], [0, 0, 1]], np.float32)
    times, valid_before = [], []
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    for k in range(MAIN_FRAMES):
        img1 = left[k, :, 32:32 + W]
        img2 = left[k, :, 32 + 8 + k:32 + 8 + k + W]  # a fronto-parallel shift
        valid_before.append(ev.state.valid if ev.state is not None else False)
        start.record()
        disp = ev(img1, img2, K, 0.54, _pose(k))
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        if disp.shape != (H, W) or not np.isfinite(disp).all() or disp.min() < 0:
            fail(f"frame {k}: disparity {disp.shape} finite={np.isfinite(disp).all()} "
                 f"min={disp.min()}")
    counts = dict(_kernels.launches)
    if valid_before[0] or not all(valid_before[1:]) or not ev.state.valid:
        fail(f"state.valid did not flip after frame 0: {valid_before}")
    want = {"corr_lookup": MAIN_ITERS * MAIN_FRAMES, "corr_lookup_bwd": 0,
            "splat_sum": MAIN_FRAMES - 1, "splat_sum_bwd": 0}
    print(f"launches {counts} expected {want}")
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    steady = sorted(times[2:])
    med = steady[len(steady) // 2]
    print(f"main path frame ms: {[round(t, 3) for t in times]}")
    print(f"main path {H}x{W} iters {MAIN_ITERS}: steady-state median "
          f"{med:.3f} ms/frame ({1000 / med:.2f} frames/s) on {smi}")
    print(f"main path peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return counts


def phase_op_gradients() -> dict:
    """``softsplat`` and ``lookup`` through their public entry points with
    inputs that require gradients, against autograd through the plain
    versions on the same CUDA tensors. Returns the launch counts."""
    from tcs_tpu_torch.ops import _kernels, corr, sampler, splat

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    B, h, w, L, r = TRAIN_B, TRAIN_H // 4, TRAIN_W // 4, 4, 4

    def leaves(*xs):
        return [x.detach().clone().requires_grad_() for x in xs]

    def check(name, got, want):
        for k, (a, b) in enumerate(zip(got, want)):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            print(f"op gradient {name}[{k}] max|d| = {err:.3e} (tol {OP_GRAD_RTOL:.0e} x "
                  f"{scale:.3e})")
            if not torch.isfinite(a).all() or not err <= OP_GRAD_RTOL * scale:
                fail(f"op gradient {name}[{k}]: {err} against {scale}")

    _kernels.reset_launches()
    values = torch.randn(B, h, w, 257, generator=g).to(dev)
    flow = (torch.randn(B, h, w, 2, generator=g) * 3.0).to(dev)
    flow[:, :, :8, 0] = -30.0
    flow[:, 50, 100:140, 0] = float("nan")
    metric = torch.randn(B, h, w, 1, generator=g).clamp(-3, 3).to(dev)
    cot = torch.randn(B, h, w, 257, generator=g).to(dev)

    def softsplat_plain(v, f, m):
        weight = torch.exp(m)
        out = splat.splat_sum_plain(torch.cat([v * weight, weight], dim=-1), f)
        return out[..., :-1] / out[..., -1:].clamp(min=1e-7)

    a = leaves(values, flow, metric)
    got = torch.autograd.grad(splat.softsplat(*a)[0], a, cot)
    b = leaves(values, flow, metric)
    want = torch.autograd.grad(softsplat_plain(*b), b, cot)
    check("softsplat", got, want)

    f1 = torch.randn(B, h, w, 64, generator=g).to(dev)
    f2 = torch.randn(B, h, w, 64, generator=g).to(dev)
    pyr = corr.corr_pyramid(corr.build_cost_volume(f1, f2), L)
    coords = (torch.rand(B, h, w, generator=g) * (w + 40) - 20).to(dev)
    cot = torch.randn(B, h, w, L * (2 * r + 1), generator=g).to(dev)
    a, b = leaves(*pyr), leaves(*pyr)
    out, ref = corr.lookup(a, coords, r), corr.lookup_plain(b, coords, r)
    err = (out - ref).abs().max().item()
    print(f"lookup forward at the training shapes max|d| = {err:.3e} "
          f"(tol {LOOKUP_TOL['float32']:.0e})")
    if not err <= LOOKUP_TOL["float32"]:
        fail(f"lookup forward at the training shapes: {err}")
    check("lookup", torch.autograd.grad(out, a, cot), torch.autograd.grad(ref, b, cot))

    # The GRUs pool hidden states that are NCHW views of channel-last memory,
    # a layout on which a library's pooling backward has been wrong on the card.
    hidden = torch.randn(B, h, w, 128, generator=g)
    cot = torch.randn(B, 128, h // 2, w // 2, generator=g)
    grads = {}
    for name, pool in (("pool2x", sampler.pool2x_nchw),
                       ("library", lambda x: torch.nn.functional.avg_pool2d(x, 3, 2, 1))):
        for d in (dev, "cpu"):
            x = hidden.to(d).permute(0, 3, 1, 2).requires_grad_()
            grads[name, str(d)] = torch.autograd.grad(pool(x), x, cot.to(d))[0].cpu()
    check("pool2x, channel-last input", [grads["pool2x", "cuda"]], [grads["pool2x", "cpu"]])
    # Not held to a bound: it says whether pool2x still needs its contiguous copy.
    err = (grads["library", "cuda"] - grads["library", "cpu"]).abs().max().item()
    print(f"avg_pool2d of the channel-last view itself, card against CPU: max|d| = {err:.3e} "
          f"of a largest entry {grads['library', 'cpu'].abs().max().item():.3e} "
          f"(torch {torch.__version__})")
    torch.cuda.synchronize()
    counts = dict(_kernels.launches)
    want_counts = {"corr_lookup": 1, "corr_lookup_bwd": 1, "splat_sum": 1, "splat_sum_bwd": 1}
    print(f"op gradient launches {counts} expected {want_counts}")
    if counts != want_counts:
        fail(f"op gradient launch counts {counts} != {want_counts}")
    return counts


def _synthetic_batch(B, H, W, frames, seed, device, generic_pose=False):
    from tcs_tpu_torch.data.synthetic import make_clips
    from tcs_tpu_torch.train import SequenceBatch

    return SequenceBatch.from_numpy(make_clips(B, H, W, frames, seed, generic_pose), device)


def phase_small_gradient_parity() -> None:
    """Loss and a few leaves' gradients of a 2-frame window, card with the
    kernels against CPU with the plain versions, fp32, TF32 off.

    Two fp32 runs put a few dozen of the model's ReLU units on different
    sides of their kinks, and each such unit moves a leaf by up to percents
    (``tcs_tpu_torch/utils/kinks.py``). So the card runs twice: as it is, held
    to ``SMALL_GRAD_RTOL_FREE``, and with every unit on the side the CPU run
    took, where every parameter with a live gradient is held to
    ``SMALL_GRAD_RTOL``, which only the arithmetic's rounding has to meet.
    """
    from tcs_tpu_torch import ModelConfig, TrainConfig
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.train.train_step import accumulate_window_grads
    from tcs_tpu_torch.utils.kinks import Kinks

    mcfg = ModelConfig(mixed_precision=False, corr_dtype="float32")
    cfg = TrainConfig(model=mcfg, train_iters=SMALL_ITERS, batch_size=2,
                      image_size=(SMALL_H, SMALL_W), frame_length=2)

    def run(dev, replay=None):
        model = TCStereo(mcfg, device=dev, seed=61)
        batch = _synthetic_batch(2, SMALL_H, SMALL_W, 2, 7, dev, generic_pose=True)
        with Kinks(replay) as kinks:
            metrics = accumulate_window_grads(model, cfg, batch)
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        return metrics["live_loss"].item(), grads, kinks

    with tf32_off():
        lp, gp, kp = run("cpu")
        free = run("cuda")
        pinned = run("cuda", replay=kp.sides)
    units = sum(m.numel() for m in kp.sides)
    print(f"small gradient parity: {free[2].crossed(kp.sides)} of {units} ReLU units fall "
          f"on another side of their kink on the card than on the CPU")
    # A bias ahead of an instance norm has no gradient but rounding.
    gmax = max(g.abs().max().item() for g in gp.values())
    live = [k for k, g in gp.items()
            if g.abs().max().item() > 1e-5 * gmax or k in SMALL_GRAD_LEAVES]
    for tag, (lc, gc, _), rtol, leaves in (
            ("as it runs", free, SMALL_GRAD_RTOL_FREE, SMALL_GRAD_LEAVES),
            ("kinks pinned", pinned, SMALL_GRAD_RTOL, live)):
        print(f"small gradient parity, {tag}: loss card {lc:.6f} cpu {lp:.6f} "
              f"(tol {SMALL_LOSS_RTOL:.0e} relative)")
        if not np.isfinite(lc) or not abs(lc - lp) <= SMALL_LOSS_RTOL * abs(lp):
            fail(f"small-model loss, {tag}: card {lc} against CPU {lp}")
        share = {k: ((gc[k] - gp[k]).abs().max() / gp[k].abs().max()).item() for k in leaves}
        worst = max(share, key=share.get)
        for k in dict.fromkeys((*SMALL_GRAD_LEAVES, worst)):
            print(f"small gradient parity, {tag}: {k} max|d| = {share[k]:.2e} of the "
                  f"largest entry (tol {rtol:.0e})")
        print(f"small gradient parity, {tag}: worst of {len(leaves)} leaves: {worst}")
        if not all(torch.isfinite(g).all() for g in gc.values()) or not share[worst] <= rtol:
            fail(f"small-model gradient of {worst}, {tag}: {share[worst]} of the largest entry")


def phase_training_path(smi: str) -> dict:
    """``make_train_step`` at the SceneFlow recipe's shapes, default config."""
    from tcs_tpu_torch.config import sceneflow_recipe
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.ops import _kernels
    from tcs_tpu_torch.train import make_train_step

    cfg = sceneflow_recipe()  # default ModelConfig: bf16 conv stacks, bf16 pyramid
    if (cfg.batch_size, *cfg.image_size, cfg.frame_length, cfg.train_iters) != (
            TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_FRAMES, TRAIN_ITERS):
        fail("the SceneFlow recipe no longer has the shapes this phase states")
    model = TCStereo(cfg.model, seed=0)
    step = make_train_step(model, cfg)
    batch = _synthetic_batch(TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_FRAMES, cfg.seed, "cuda")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    losses, norms, times = [], [], []
    for _ in range(TRAIN_WARM + TRAIN_TIMED):
        start.record()
        metrics = step(batch)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        losses.append(metrics["live_loss"].item())
        norms.append(metrics["grad_norm"].item())
        if not all(np.isfinite(v.item()) for v in metrics.values()):
            fail(f"a training metric is not finite: "
                 f"{ {k: v.item() for k, v in metrics.items()} }")
    counts = dict(_kernels.launches)
    steps = TRAIN_WARM + TRAIN_TIMED
    want = {"corr_lookup": steps * TRAIN_FRAMES * TRAIN_ITERS,
            "corr_lookup_bwd": steps * TRAIN_FRAMES * TRAIN_ITERS,
            "splat_sum": steps * (TRAIN_FRAMES - 1), "splat_sum_bwd": 0}
    print(f"training launches {counts} expected {want}")
    if counts != want:
        fail(f"training launch counts {counts} != {want}")
    print(f"training live_loss per step: {[round(v, 5) for v in losses]}; "
          f"grad_norm: {[round(v, 4) for v in norms]}; epe of the last step "
          f"{metrics['epe'].item():.4f} px")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall on a repeated batch: {losses}")
    if not all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters()):
        fail("a parameter has no gradient or a non-finite one")
    timed = sorted(times[TRAIN_WARM:])
    med = timed[len(timed) // 2]
    print(f"training step ms: {[round(t, 2) for t in times]} (first is the warm-up)")
    print(f"training path B{TRAIN_B} {TRAIN_H}x{TRAIN_W} frames {TRAIN_FRAMES} iters "
          f"{TRAIN_ITERS}: median {med:.2f} ms/step, "
          f"{TRAIN_B * TRAIN_FRAMES * 1000 / med:.2f} frames/s on {smi}")
    print(f"training peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = phase_device()
    rate = hbm_bytes_per_s(smi)
    launch_floor()
    rec = phase_kernels(rate)
    phase_small_parity()
    paths = {"inference": phase_main_path(smi), "op_gradients": phase_op_gradients()}
    phase_small_gradient_parity()
    paths["training"] = phase_training_path(smi)
    # `launches` sums the driven paths, each of which set the counts to 0
    # before it and read them after. The times and the bound are at the
    # shapes of the path that launches the kernel most, in the type it runs
    # there: the inference path's for the forward kernels, the training
    # path's for the backward ones; bf16 pyramids, fp32 splat payloads. The
    # forward kernels' numbers at the training path's shapes stand beside
    # them, and `max_abs_err` is the largest over every shape and type checked.
    sources = {
        "corr_lookup": ("corr_lookup.cu", "tcs_tpu/ops/pallas/corr_kernel.py:76", "bfloat16"),
        "corr_lookup_bwd": ("corr_lookup_bwd.cu", "tcs_tpu/ops/corr.py:341", "bfloat16"),
        "splat_sum": ("softsplat.cu", "tcs_tpu/ops/splat.py:30", "float32"),
        "splat_sum_bwd": ("softsplat_bwd.cu", "tcs_tpu/ops/splat.py:139", "float32"),
    }
    keys = ("ms", "cold_ms", "plain_ms", "bound_ms", "library_ms")
    kernels = []
    for name, (src, replaces, dtype) in sources.items():
        by_path = {p: c[name] for p, c in paths.items()}
        mine = {k: v for k, v in rec.items() if k[0] == name}
        shape = "training" if name.endswith("_bwd") else "inference"
        entry = dict(
            name=name, route="cuda", source="tcs_tpu_torch/csrc/" + src, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in mine.values()),
            bound_by="bytes", **{k: rec[name, shape, dtype].get(k) for k in keys})
        if shape == "inference":
            entry["at_training_shapes"] = {k: rec[name, "training", dtype].get(k) for k in keys}
        kernels.append(entry)
        for (_, sh, dt), r in mine.items():
            print(f"{name} [{sh}, {dt}]: ms {r['ms']:.4f} cold_ms {r['cold_ms']:.4f} "
                  f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
                  f"bound_ms {r['bound_ms']:.4f} max|d| {r['max_abs_err']:.3e}")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
