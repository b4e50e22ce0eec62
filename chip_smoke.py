#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit, torch/CUDA versions, and the
   build of the hand-written kernels from ``tcs_tpu_torch/csrc``;
2. kernel checks: each kernel against its plain PyTorch version on the card,
   with times (CUDA events; the L2 warm, and cold after a 128 MB write), the
   card's launch floor, bounds and library yardsticks: both lookup kernels at
   the inference path's shapes (batch 1, 96×320 grid), the training path's
   (batch 4, 80×180 grid), the fl4 recipes' (batch 4; 120×160 TartanAir,
   80×256 KITTI raw) and the evaluators' (batch 1; 120×160, 136×240 and
   96×312 grids) for fp32 and bf16 pyramids, with non-finite and far-out
   coordinates; the splat at all seven shapes and under collapsing columns,
   bit for bit against its plain version on the CPU and launch against
   launch; its backward at the training path's;
3. small-model parity: the fp32 config at 64×96 for 3 frames, on the card
   with the kernels and on the CPU with the plain versions, same weights, for
   the default architecture and three variants that together touch every
   one (group and instance context norms with the non-shared backbone and
   the slow-fast GRUs; batch norm on the shared backbone);
4. main path: ``TemporalEvaluator`` over the default config (bf16 conv
   stacks, bf16 pyramid) at 384×1280, iters 5, 12 frames with a moving pose,
   with the kernels' launch counts read around it;
5. op-level gradients: ``softsplat`` and ``lookup`` through their public
   entry points on inputs that require gradients, against autograd through
   the plain versions (this path launches the splat's backward kernel),
   ``pool2x`` on a channel-last hidden state against the CPU, and the
   sampler's helpers that no path calls, card against CPU: ``upflow`` (x2,
   x4, x8), ``pool4x`` (forward, and its gradient on a channel-last view)
   and ``median_filter`` (k 2, 3, 5);
6. small-model gradient parity: the fp32 config at 64×96, 2 frames, 2
   iterations: loss and the gradients of a few leaves, card with kernels
   against CPU with plain versions, as the model runs and with the ReLU
   kinks pinned to the CPU run's sides;
7. training path: ``make_train_step`` over the default config at the
   SceneFlow recipe's shapes (batch 4, 320×720, 2 frames, 5 iterations) on a
   synthetic batch from a seed: 1 warm-up step and 3 timed steps, with the
   launch counts read around them;
8. the evaluators: ``validate_tartanair``, ``validate_temporal_things`` and
   ``submit_kitti`` (submission PNG, then the pseudo-colour MJPG ``.avi``,
   parsed and decoded with the port's reader and held frame by frame to
   the encoding of its disparity's colour map) over the
   default config at each dataset's frame size (480×640, 540×960,
   375×1242), iters 5, on trees fabricated from a seed; ms/frame over the
   call and over the frames after the first, the first frame's time, and the
   kernels' launches around each; each held against a direct drive of the
   same frames through ``TemporalEvaluator``, the card against the CPU at
   64×96, and the evaluation CLI in a subprocess against the in-process run;
9. training from files: training trees at the datasets' frame sizes,
   ``read_png`` through the host core against the numpy path, the loader's
   samples/s at 1, 4 and 8 workers, phase 7's step in this process on its
   resident batch and on the loader's batches around the SceneFlow recipe
   run through the training CLI, a SIGTERM to a CLI run's process group and
   its resume under ``--deterministic``, held bit for bit (every step's loss
   and gradient norm, the last weights) to an uninterrupted
   ``--deterministic`` run, with the ms/step with and without the flag and
   the library calls torch reports as nondeterministic in the bf16 step
   under it, and the two fl4 recipes through the CLI; each CLI step's
   launches held to its window's;
10. data parallelism (``tcs_tpu_torch/parallel/mesh.py``): (a) phase 7's
   step under DDP at world size 1 over NCCL in this process, against the
   plain step from the same weights and batch, and timed beside it; (b) two
   ranks sharing the card over Gloo, each with 4 of one batch of 8 (fp32,
   TF32 off), against one process's step on the 8; (c) the training CLI
   under ``python -m torch.distributed.run`` (NCCL) on phase 9's SceneFlow
   tree, stopped by a SIGTERM to the launcher's process group and resumed;
   (d) the evaluation CLI with ``--sharded`` under the launcher on phase 8's
   TartanAir tree against phase 8's in-process results; (e) with two cards
   or more, (b) over NCCL across two of them;
11. trained weights and convergence: (a) ``tcs_tpu``'s trained weights
   (``tests/fixtures/convergence_params.npz``, read by
   ``utils.checkpoint.load_params_npz``) through the port on the card and on
   the CPU, four two-plane clips of 2 frames at 64×96, iters 5, in the fp32
   config (TF32 off) and the default bf16 config; (b) on the card, the
   carried temporal state against a reset on those clips with frame 1's
   foreground erased from the right view, in both configs; (c)
   ``save_params_npz`` of the loaded weights against the fixture's arrays;
   (d) ``scripts/torch_convergence_synthetic.py``'s run in this process at
   its defaults: 300 training steps, then carried against reset on 8
   held-out clips;
12. JPEG and traces: (a) the committed JPEG fixtures (``tests/fixtures/
   jpeg/``) decoded by the port to ``tcs_tpu``'s digests, and the committed
   image encoded by the port to PIL's bytes; (b) a
   FallingThings tree at 960x540 written with the port's encoder, its
   decode and encode times, and ``fetch_dataset('falling_things')`` through
   the loader; (c) ``utils.profiling.trace`` with module ranges around 3
   frames of phase 4's main path and one step of phase 7's training step,
   ``trace_summary.summarize_trace`` of each (device time and events, the
   tables by module, family, kernel and stage span, the share of no module), each hand
   kernel's events in the trace held to its wrapper's launch count;
13. ``tcs_tpu``'s Orbax checkpoints, read and written by the port alone
   (``utils/zstd.py``, ``utils/ocdbt.py``, ``utils/orbax_format.py``): (a)
   the committed fixtures (``tests/fixtures/orbax/``: zstd frames, a
   ``CheckpointManager`` directory with an uncommitted step, a
   ``save_params`` export) decoded on the card's host to ``tcs_tpu``'s
   digests bit for bit; (b) ``tcs_tpu``'s trained weights at the SceneFlow
   recipe (B4 320x720, 2 frames, 5 iterations) in the fp32 config with TF32
   off and cuDNN's deterministic algorithms (``tcs_tpu_torch.device.
   deterministic``, the trainer's ``--deterministic``): 3 steps, the state written with
   ``save_tcs_tpu`` and read into a fresh model, AdamW and schedule (equal bit
   for bit: every parameter, both moments, the step, the learning rate), 3
   more steps held to the 3 that the written run takes on (bit for bit, or,
   where they differ, the library calls torch reports as nondeterministic
   named and the losses held to 1e-6), with the write and read rates; (c) the evaluation CLI on phase 8's TartanAir tree with
   ``--restore_ckpt`` on (b)'s ``save_params`` export, against the same
   weights loaded directly;
14. measurement tools (``tcs_tpu_torch/utils/flops.py`` and the
   ``scripts/torch_*`` benches): the model FLOPs of the small fp32 model at
   64x96 (one carried frame at 2 iterations, one 2-frame training step),
   counted on the card with the kernels and on the CPU with the plain
   versions, equal to the integer; ``scripts/torch_mfu.py``'s inference
   (phase 4's shapes) and SceneFlow step (phase 7's) in this process, each
   share of the card's dense bf16 peak (over the call's time by CUDA events
   and over its device time) held inside (0, 1.05]. The stage table (the
   device time launched in each ``tcs::`` span) is phase 12's, in place.

The last line of standard output is the JSON device record. Run from the
repository root: ``python chip_smoke.py``. ``python chip_smoke.py
--loader-cores`` runs phase 1 and then only ``loader_cores_probe``: phase
7's step on the loader's batches with the workers sharing the host's cores
in several ways.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_H, MAIN_W, MAIN_ITERS, MAIN_FRAMES = 384, 1280, 5, 12
SMALL_H, SMALL_W, SMALL_ITERS, SMALL_FRAMES = 64, 96, 2, 3
FLOW_TOL = 5e-2  # px; the bound the CPU tests hold the port to against tcs_tpu
LOOKUP_TOL = {"float32": 1e-5, "bfloat16": 1e-6}
# The splat kernel must equal splat_sum_plain on CPU copies bit for bit. Only
# the earlier atomic designs, which scripts/bench_splat_kernel.py times beside
# it, are held to a share of max |reference| instead: atomics reorder the sums.
SPLAT_ATOMIC_RTOL = 1e-5
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

# Phase 8, by dataset: (fabricator, its keyword arguments, sequences, frames each).
EVAL_ITERS = 5
EVAL_TREES = {
    "TartanAir": ("tartanair_tree", dict(frames=6, height=480, width=640), 2, 6),
    "things": ("things_tree", dict(frames=10, height=540, width=960), 1, 10),
    "kitti": ("kitti_tree", dict(frames=11, height=375, width=1242), 1, 11),
}
EVAL_DIRECT_TOL = 1e-3  # px: evaluator against a direct drive of the same frames, same card

# Phase 11: tcs_tpu's trained weights and tests/test_train.py's protocol, the
# card against the CPU in the fp32 config with TF32 off.
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "convergence_params.npz")
FIXTURE_H, FIXTURE_W, FIXTURE_CLIPS, FIXTURE_ITERS = 64, 96, 4, 5
TRAINED_TOL = 1e-3
FIXTURE_CONFIGS = {"fp32": dict(mixed_precision=False, corr_dtype="float32"), "bf16": {}}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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


def card_line() -> str:
    """The first card's ``nvidia-smi --query-gpu=name,power.limit`` line."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def phase_device():
    from tcs_tpu_torch.ops import _kernels

    smi = card_line()
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


def check_splat_forward(tag, values, flow, rate, exact=True) -> dict:
    """``splat.splat_sum`` against ``splat_sum_plain`` run on CPU copies of the
    inputs, which it must equal bit for bit, and two launches against each
    other; with times (warm and cold), the ``index_add_`` yardstick and the
    bound. ``exact=False`` is for another tree's atomic design: both checks
    are recorded and the kernel is held to ``SPLAT_ATOMIC_RTOL`` instead."""
    from tcs_tpu_torch.ops import splat

    C = values.shape[-1]
    first, second = splat.splat_sum(values, flow), splat.splat_sum(values, flow)
    ref = splat.splat_sum_plain(values.cpu(), flow.cpu())
    out = first.cpu()
    deterministic = torch.equal(out, second.cpu())
    bit_exact = torch.equal(out, ref)
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    print(f"splat_sum[{tag}] bit-exact against splat_sum_plain on the CPU: {bit_exact}; "
          f"two launches equal: {deterministic}; max|d| = {err:.3e} of max|ref| {scale:.3e}")
    if not torch.isfinite(out).all():
        fail(f"splat_sum[{tag}]: a non-finite output")
    if exact and not (bit_exact and deterministic):
        fail(f"splat_sum[{tag}] is not bit-exact and deterministic: max|d| {err}")
    if not exact and not err <= SPLAT_ATOMIC_RTOL * scale:
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
                bound_ms=nbytes / rate * 1e3, library_ms=library_ms,
                deterministic=deterministic, bit_exact=bit_exact)


def _collision_flow(B, h, w, g, dev):
    """A (B, h, w, 2) flow under which columns collapse: eight onto one in the
    top half of the rows (buckets of about 16 keys), 32 onto one in the bottom
    half (about 64 keys: the kernel's path for buckets over 32)."""
    xs = torch.arange(w, dtype=torch.float32)
    fx = torch.where(torch.arange(h)[:, None] < h // 2, -(xs % 8), -(xs % 32))
    fx = fx + torch.rand(B, h, w, generator=g) * 0.25
    fy = torch.randn(B, h, w, generator=g) * 0.7
    return torch.stack([fx, fy], -1).to(dev)


def splat_records(rate: float, g: torch.Generator, exact: bool = True) -> tuple:
    """The splat forward against its plain version at every path's shapes,
    (B, h, w, 258) fp32 with out-of-image and non-finite targets, and at the
    inference path's shape under collapsing columns: records by (kernel,
    shape, type). The values and flows are returned beside them."""
    dev = torch.device("cuda")
    records, inputs = {}, {}
    C = 258  # the warp's payload
    for shape, (B, h, w) in LOOKUP_SHAPES.items():
        values = torch.randn(B, h, w, C, generator=g).to(dev)
        inputs[shape] = values, _bad_flow(B, h, w, g, dev)
    B, h, w = LOOKUP_SHAPES["inference"]
    inputs["collisions"] = inputs["inference"][0], _collision_flow(B, h, w, g, dev)
    for shape, (values, flow) in inputs.items():
        B, h, w, _ = values.shape
        records["splat_sum", shape, "float32"] = check_splat_forward(
            f"{shape}, B{B} {h}x{w}x{C}", values, flow, rate, exact)
    return records, inputs


# The fl4 recipes' crops, (H, W) at batch TRAIN_B, as config.RECIPES has them
# (phase 2 checks that it still does); phase 9 trains them from files.
FL4_CROPS = {"TartanAir": (480, 640), "kitti_raw": (320, 1024)}
# Grid of the lookup and the splat on each path: (batch, h, w) at a quarter of
# the image, padded to /32 as the model pads it; the evaluators' at each
# dataset's frame size (KITTI's top pyramid level is 39 wide, an odd width).
LOOKUP_SHAPES = {"inference": (1, MAIN_H // 4, MAIN_W // 4),
                 "training": (TRAIN_B, TRAIN_H // 4, TRAIN_W // 4),
                 **{f"training {name}": (TRAIN_B, H // 4, W // 4)
                    for name, (H, W) in FL4_CROPS.items()},
                 **{f"evaluation {name}": (1, -(-kw["height"] // 32) * 8, -(-kw["width"] // 32) * 8)
                    for name, (_, kw, _, _) in EVAL_TREES.items()}}
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
    """Both lookup kernels against their plain versions at every path's
    shapes, fp32 and bf16 pyramids: records by (kernel, shape, type)."""
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
    """Every kernel against its plain version: both lookup kernels and the
    splat at each path's shapes (``LOOKUP_SHAPES``), the splat also under
    collapsing columns, its backward at the training path's. Records by
    (kernel, shape, type)."""
    from tcs_tpu_torch.config import RECIPES
    from tcs_tpu_torch.ops import splat

    for name, (H, W) in FL4_CROPS.items():
        cfg = RECIPES[name]()
        if (cfg.batch_size, *cfg.image_size) != (TRAIN_B, H, W):
            fail(f"the {name} recipe no longer has the shapes phase 2 checks")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    records = lookup_records(rate, g)
    splats, inputs = splat_records(rate, g)
    records.update(splats)
    values, flow = inputs["training"]
    B, h, w, C = values.shape
    tag = f"B{B} {h}x{w}x{C}"
    gsplat = torch.randn(B, h, w, C, generator=g).to(dev)
    v, f = values.clone().requires_grad_(), flow.clone().requires_grad_()
    dv, df = torch.autograd.grad(splat.splat_sum(v, f), (v, f), gsplat)
    again = splat._launch_splat_sum_bwd(gsplat, values, flow)
    rdv, rdf = splat.splat_sum_bwd_plain(gsplat, values, flow)
    torch.cuda.synchronize()
    deterministic = torch.equal(dv, again[0]) and torch.equal(df, again[1])
    bit_exact = torch.equal(dv, rdv) and torch.equal(df, rdf)
    print(f"splat_sum_bwd[{tag}] two launches equal: {deterministic}; bit-exact against "
          f"splat_sum_bwd_plain: {bit_exact}")
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
        bound_ms=nbytes / rate * 1e3, library_ms=library_ms,
        deterministic=deterministic, bit_exact=bit_exact)
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


SMALL_VARIANTS = {
    "default": {},
    "group-fnet-slowfast": dict(context_norm="group", shared_backbone=False,
                                slow_fast_gru=True),
    "batch-shared": dict(context_norm="batch"),
    "instance-fnet-slowfast": dict(context_norm="instance", shared_backbone=False,
                                   slow_fast_gru=True),
}


def phase_small_parity() -> None:
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.models import TCStereo, TemporalState

    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 255, (SMALL_FRAMES, 2, 1, SMALL_H, SMALL_W, 3)).astype(np.float32)
    for name, variant in SMALL_VARIANTS.items():
        cfg = ModelConfig(mixed_precision=False, corr_dtype="float32", **variant)
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
            print(f"small parity [{name}] frame {k}: max|dflow| = {d:.3e} (tol {FLOW_TOL})")
            if not d <= FLOW_TOL:
                fail(f"small-model GPU/CPU parity [{name}], frame {k}: {d}")


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
    sampler_helpers(hidden, g, check)
    torch.cuda.synchronize()
    counts = dict(_kernels.launches)
    want_counts = {"corr_lookup": 1, "corr_lookup_bwd": 1, "splat_sum": 1, "splat_sum_bwd": 1}
    print(f"op gradient launches {counts} expected {want_counts}")
    if counts != want_counts:
        fail(f"op gradient launch counts {counts} != {want_counts}")
    return counts


def sampler_helpers(hidden, g, check) -> None:
    """``upflow``, ``pool4x`` and ``median_filter`` on the card against the
    CPU, and ``pool4x``'s gradient on a channel-last view (``hidden``, the
    GRUs' layout) through ``check``; no path calls them."""
    from tcs_tpu_torch.ops import sampler

    dev = torch.device("cuda")
    B, h, w, _ = hidden.shape
    flow_q = torch.randn(B, h, w, 1, generator=g) * 8.0
    # values on a grid of eighths: the median filters meet ties
    ties = torch.round(torch.randn(B, h, w, 8, generator=g) * 8.0) / 8.0
    cases = [(f"upflow x{f}", lambda x, f=f: sampler.upflow(x, f), flow_q) for f in (2, 4, 8)]
    cases += [("pool4x", sampler.pool4x, hidden)]
    cases += [(f"median_filter k{k}", lambda x, k=k: sampler.median_filter(x, k), ties)
              for k in (2, 3, 5)]
    for name, fn, x in cases:
        got, want = fn(x.to(dev)).cpu(), fn(x)
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        exact = torch.equal(got, want)
        print(f"{name} {tuple(x.shape)}, card against CPU: max|d| = {err:.3e} of "
              f"{scale:.3e}, equal bit for bit: {exact}")
        # a selection is exact; the others to a millionth of their largest entry
        if got.shape != want.shape or not (exact if name.startswith("median") else
                                           err <= 1e-6 * scale):
            fail(f"{name} on the card differs from the CPU: {err} of {scale}")
    cot = torch.randn(B, 128, (h - 3) // 4 + 1, (w - 3) // 4 + 1, generator=g)
    grads = {}
    for name, pool in (("pool4x", sampler.pool4x_nchw),
                       ("library", lambda x: torch.nn.functional.avg_pool2d(x, 5, 4, 1))):
        for d in (dev, "cpu"):
            x = hidden.to(d).permute(0, 3, 1, 2).requires_grad_()
            grads[name, str(d)] = torch.autograd.grad(pool(x), x, cot.to(d))[0].cpu()
    check("pool4x, channel-last input", [grads["pool4x", "cuda"]], [grads["pool4x", "cpu"]])
    # Not held to a bound: whether pool4x needs its contiguous copy.
    err = (grads["library", "cuda"] - grads["library", "cpu"]).abs().max().item()
    print(f"avg_pool2d(5, 4, 1) of the channel-last view itself, card against CPU: max|d| = "
          f"{err:.3e} of a largest entry {grads['library', 'cpu'].abs().max().item():.3e} "
          f"(torch {torch.__version__})")


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


def phase_training_path(smi: str):
    """``make_train_step`` at the SceneFlow recipe's shapes, default config;
    returns the launch counts and the median ms/step."""
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
    return counts, med


@contextlib.contextmanager
def recorded_disparities():
    """Keeps every disparity ``TemporalEvaluator`` returns, one (H, W) array
    per frame, in the first list this yields, and the host clock's
    (start, end) of each call in the second. The call returns numpy, so at
    its end the device has finished the frame."""
    from tcs_tpu_torch.evaluate import TemporalEvaluator

    call, store, spans = TemporalEvaluator.__call__, [], []

    def recording(self, *args):
        t0 = time.perf_counter()
        out = call(self, *args)
        spans.append((t0, time.perf_counter()))
        store.append(out)
        return out

    TemporalEvaluator.__call__ = recording
    try:
        yield store, spans
    finally:
        TemporalEvaluator.__call__ = call


def eval_sequences(name: str, root: str) -> list:
    """(left paths, right paths, ground-truth reader and paths, K, baseline,
    poses) of each sequence an evaluator reads, through the port's datasets."""
    from tcs_tpu_torch import evaluate as ev
    from tcs_tpu_torch.data import frame_utils

    if name in ("TartanAir", "things"):
        if name == "TartanAir":
            ds = ev.TartanAir(None, root=root, test_keywords=ev.tartanair_test_keywords(),
                              is_test=True, mode="temporal")
            read_gt, K, baseline = (lambda p: frame_utils.readDispTartanAir(p)[0],
                                    ev.TARTANAIR_TEST_K, 0.25)
        else:
            ds = ev.SceneFlowDatasets(None, root=root, things_test=True, mode="temporal")
            read_gt, K, baseline = frame_utils.read_gen, ev.SCENEFLOW_TEST_K, 1.0
        return [(left, right, read_gt, gts, K, baseline, poses)
                for left, right, gts, poses in map(ds.test_sequence, range(len(ds)))]
    ds = ev.KITTI(None, root=os.path.join(root, "KITTI"), is_test=True, mode="temporal",
                  image_set="kitti_seq/kitti2015_testings", index_by_scene=True)
    out = []
    for i in range(len(ds)):
        left, right, scene, poses = ds.test_sequence(i)
        calib = frame_utils.read_calib_file(os.path.join(scene, os.path.basename(scene) + ".txt"))
        out.append((left, right, None, [], frame_utils.intrinsics_from_p_rect(
            calib["P_rect_02"]), 0.54, poses))
    return out


def direct_drive(model, cfg, seqs, iters, device) -> list:
    """Every frame of ``seqs`` through ``TemporalEvaluator``, reset at each
    sequence: per sequence the list of (disparity, ground truth or None)."""
    from tcs_tpu_torch.data import frame_utils
    from tcs_tpu_torch.evaluate import TemporalEvaluator

    ev = TemporalEvaluator(model, cfg, iters, device=device)
    out = []
    for left, right, read_gt, gts, K, baseline, poses in seqs:
        ev.reset()
        out.append([])
        for j, (p1, p2, T) in enumerate(zip(left, right, poses)):
            disp = ev(frame_utils.read_image(p1).astype(np.float32),
                      frame_utils.read_image(p2).astype(np.float32), K, baseline,
                      np.asarray(T, np.float32))
            out[-1].append((disp, read_gt(gts[j]) if gts else None))
    return out


def pooled_metrics(frames, prefix: str, temporal: bool) -> dict:
    """The evaluators' metrics recomputed with numpy in pooled form: D1/D3 as
    bad pixels over valid pixels across all frames (which the valid-rate
    weighting of ``tcs_tpu`` equals for frames of one size), EPE as the mean
    of the frames' means, the temporal pairs of consecutive frames."""
    epes, bad1, bad3, valid, tc = [], 0, 0, 0, []
    for seq in frames:
        for j, (disp, gt) in enumerate(seq):
            ok = np.abs(gt) < 192.0
            err = np.abs(disp - gt)
            epes.append(err[ok].mean())
            bad1, bad3, valid = bad1 + (err[ok] > 1).sum(), bad3 + (err[ok] > 3).sum(), valid + ok.sum()
            if temporal and j:
                pd, pg = seq[j - 1]
                both = ok & (np.abs(pg) < 192.0)
                dd = (disp - pd) - (gt - pg)
                de = err - np.abs(pd - pg)
                tc.append(((np.abs(dd) > 3)[both].mean(), (de > 3)[both].mean()))
    out = {f"{prefix}-epe": float(np.mean(epes)), f"{prefix}-d1": 100.0 * bad1 / valid,
           f"{prefix}-d3": 100.0 * bad3 / valid}
    if tc:
        out[f"{prefix}-tc-dd3"] = 100.0 * float(np.mean([t[0] for t in tc]))
        out[f"{prefix}-tc-de3"] = 100.0 * float(np.mean([t[1] for t in tc]))
    return out


METRIC_ROUNDING = 1e-9  # two float64 formulas of one metric (pooled or weighted) part by ~1e-14


def hold_metrics(tag: str, got: dict, want: dict, bounds: dict) -> None:
    """``got`` against ``want``, metric by metric, within ``bounds`` (from
    ``evaluate.metric_bounds``) plus ``METRIC_ROUNDING``."""
    if got.keys() != want.keys() or got.keys() != bounds.keys():
        fail(f"{tag}: metric keys {sorted(got)} against {sorted(want)}")
    for k in got:
        d = abs(got[k] - want[k])
        print(f"{tag}: {k} {got[k]:.6f} against {want[k]:.6f}, |d| {d:.3e} "
              f"(bound {bounds[k]:.3e})")
        if not np.isfinite(got[k]) or not d <= bounds[k] + METRIC_ROUNDING:
            fail(f"{tag}: {k} {got[k]} against {want[k]}, bound {bounds[k]}")


def phase_evaluators(smi: str) -> dict:
    """The three evaluators at full width and their datasets' frame sizes;
    returns the launch counts of the four evaluator calls, summed."""
    import tempfile

    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch import evaluate as ev
    from tcs_tpu_torch.data import fabricate, frame_utils
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.ops import _kernels
    from tcs_tpu_torch.utils.checkpoint import save_weights

    os.makedirs("runs", exist_ok=True)
    tmp_dir = tempfile.TemporaryDirectory(prefix="eval_trees_", dir="runs")
    root = tmp_dir.name
    t0 = time.perf_counter()
    for seed, (name, (fab, kw, n_seq, _)) in enumerate(EVAL_TREES.items()):
        if name == "TartanAir":
            kw = dict(kw, sequences=(("gascola", "Easy", "P001"), ("hospital", "Hard", "P042")))
        getattr(fabricate, fab)(root, seed=seed, **kw)
    small, small_n = os.path.join(root, "small"), 6  # frames of each small sequence
    fabricate.tartanair_tree(small, frames=small_n, height=SMALL_H, width=SMALL_W, seed=7)
    print(f"evaluators: trees written in {time.perf_counter() - t0:.2f} s")

    cfg = ModelConfig()  # mixed precision, bf16 pyramid
    model = TCStereo(cfg, seed=0)
    out_dir = os.path.join(root, "kitti_out")
    calls = {
        "TartanAir": (ev.validate_tartanair, dict(root=root)),
        "things": (ev.validate_temporal_things, dict(root=root)),
        "kitti": (ev.submit_kitti, dict(root=os.path.join(root, "KITTI"), out_dir=out_dir)),
        "kitti video": (ev.submit_kitti, dict(root=os.path.join(root, "KITTI"),
                                              out_dir=out_dir, submission=False)),
    }
    total = dict.fromkeys(_kernels.launches, 0)
    results, recorded = {}, {}
    for name, (fn, kw) in calls.items():
        _, _, n_seq, n_frames = EVAL_TREES[name.split()[0]]
        frames = n_seq * n_frames
        with recorded_disparities() as (disps, spans):
            torch.cuda.synchronize()
            _kernels.reset_launches()
            t0 = time.perf_counter()
            results[name] = fn(model, cfg, iters=EVAL_ITERS, **kw)
            t1 = time.perf_counter()
            counts = dict(_kernels.launches)
        recorded[name] = disps
        want = {"corr_lookup": frames * EVAL_ITERS, "corr_lookup_bwd": 0,
                "splat_sum": frames - n_seq, "splat_sum_bwd": 0}
        print(f"evaluator {name}: {json.dumps(results[name])}")
        # The first frame of a call pays for its shape once (the allocator's
        # pools, cuDNN's choice of algorithms); a run over a dataset's
        # hundreds of frames spreads that over all of them.
        model_ms = [1e3 * (b - a) for a, b in spans]
        steady = 1e3 * (t1 - spans[0][1]) / (frames - 1)
        print(f"evaluator {name}: {frames} frames in {t1 - t0:.3f} s, "
              f"{1e3 * (t1 - t0) / frames:.3f} ms/frame over the call; steady "
              f"{steady:.3f} ms/frame over frames 2-{frames} (from the end of the first "
              f"frame's model call to the end of the call); files read and written "
              f"included; on {smi}")
        print(f"evaluator {name}: model call per frame (TemporalEvaluator, no file "
              f"reads): first {model_ms[0]:.3f} ms, then median "
              f"{float(np.median(model_ms[1:])):.3f} ms, all {[round(t, 3) for t in model_ms]}")
        print(f"evaluator {name}: launches {counts} expected {want}")
        if counts != want or len(disps) != frames:
            fail(f"evaluator {name}: launches {counts} against {want}, {len(disps)} frames")
        for k in total:
            total[k] += counts[k]
        if not all(np.isfinite(d).all() and d.min() >= 0 for d in disps):
            fail(f"evaluator {name}: a disparity is not finite or negative")
    print(f"evaluator kitti: kitti-fps {results['kitti']['kitti-fps']} (tcs_tpu's rule: only "
          f"frames after the 7th of scenes after the 51st are timed, so one scene gives 0.0)")
    check_kitti_video(os.path.join(out_dir, "video"), recorded["kitti video"], smi)

    # Each evaluator against a direct drive of the same frames, same card.
    direct = {}
    for name, prefix in (("TartanAir", "TartanAir"), ("things", "things"), ("kitti", None)):
        seqs = eval_sequences(name, root)
        direct[name] = direct_drive(model, cfg, seqs, EVAL_ITERS, "cuda")
        mine = [d for seq in direct[name] for d, _ in seq]
        err = max(np.abs(a - b).max() for a, b in zip(recorded[name], mine))
        print(f"evaluator {name} against a direct drive: max|d disparity| = {err:.3e} px "
              f"(tol {EVAL_DIRECT_TOL})")
        if len(mine) != len(recorded[name]) or not err <= EVAL_DIRECT_TOL:
            fail(f"evaluator {name} against a direct drive: {err}")
        if prefix:
            temporal = name == "TartanAir"
            hold_metrics(f"evaluator {name} against numpy", results[name],
                         pooled_metrics(direct[name], prefix, temporal),
                         ev.metric_bounds(direct[name], EVAL_DIRECT_TOL, prefix, temporal))
    png10 = frame_utils.read_uint16_png(os.path.join(out_dir, "disp_0", "000000_10.png"))
    lsb = np.abs(png10.astype(np.int64) - (direct["kitti"][0][10][0] * 256.0).astype(np.uint16))
    print(f"submit_kitti 000000_10.png against the direct drive's frame 10 x256: "
          f"max {lsb.max()} LSB (tol 1)")
    kitti_size = EVAL_TREES["kitti"][1]["height"], EVAL_TREES["kitti"][1]["width"]
    if png10.shape != kitti_size or lsb.max() > 1:
        fail(f"submit_kitti's PNG: shape {png10.shape}, {lsb.max()} LSB off")

    # The card against the CPU at 64x96, fp32, same weights.
    scfg = ModelConfig(mixed_precision=False, corr_dtype="float32")
    small_res, small_frames = {}, {}
    with tf32_off():
        for dev in ("cuda", "cpu"):
            with recorded_disparities() as (disps, _):
                small_res[dev] = ev.validate_tartanair(TCStereo(scfg, device=dev, seed=3), scfg,
                                                       iters=SMALL_ITERS, root=small, device=dev)
            small_frames[dev] = [[(d, frame_utils.readDispTartanAir(p)[0]) for d, p in
                                  zip(disps[small_n * i:small_n * (i + 1)], seq[3])]
                                 for i, seq in enumerate(eval_sequences("TartanAir", small))]
    hold_metrics("validate_tartanair 64x96, card against CPU", small_res["cuda"],
                 small_res["cpu"], ev.metric_bounds(small_frames["cpu"], FLOW_TOL, "TartanAir"))

    # The CLI in a subprocess, on the weights saved in the reference's format.
    pth = os.path.join(root, "w.pth")
    save_weights(model, pth)
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "tcs_tpu_torch.cli.evaluate", "--dataset",
                          "TartanAir", "--data_root", root, "--restore_ckpt", pth,
                          "--valid_iters", str(EVAL_ITERS)],
                         capture_output=True, text=True, timeout=600)
    print(f"evaluation CLI: exit {cli.returncode} in {time.perf_counter() - t0:.2f} s; "
          f"its standard output:\n{cli.stdout.strip()}")
    if cli.returncode != 0:
        fail(f"the evaluation CLI exited {cli.returncode}:\n{cli.stderr[-4000:]}")
    hold_metrics("evaluation CLI against the in-process run",
                 json.loads(cli.stdout.strip().splitlines()[-1]), results["TartanAir"],
                 ev.metric_bounds(direct["TartanAir"], EVAL_DIRECT_TOL, "TartanAir"))
    # phase 10 runs the sharded CLI on the same tree and weights
    return total, dict(tmp_dir=tmp_dir, root=root, pth=pth, results=results["TartanAir"])


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


# The lowest PSNR a frame of phase 8's video may have against the pseudo-colour
# map it encodes. The port's q95 4:2:0 frames read 31.38 dB at the lowest on
# NVIDIA H100 80GB HBM3 at 700 W (the random weights' rough disparity has
# sharp colour edges that 4:2:0 blurs). The floor catches a gross fault of the
# encoder; a subtle one (a coarser quantiser, a colour weight off by 0.1)
# moves the PSNR by a few dB or less, and phase 12 (a), which holds the
# encoder's bytes to PIL's, catches it.
VIDEO_PSNR_FLOOR = 30.0


def check_kitti_video(video_dir: str, disps: list, smi: str) -> None:
    """``submit_kitti(submission=False)``'s ``.avi``, parsed and decoded with
    the port's own reader and decoder: MJPG at 2 fps, the scene's size and
    frame count, each frame the port's encoding (quality 95) of the
    pseudo-colour map of the disparity ``TemporalEvaluator`` gave for it, bit
    for bit, and each frame at least ``VIDEO_PSNR_FLOOR`` dB from that map.
    The bit-for-bit check ties the frames to their maps; the floor holds the
    encoder's error against the map (phase 12 (a) holds its bytes to PIL's)."""
    from tcs_tpu_torch.data.jpeg import encode_jpeg, read_jpeg
    from tcs_tpu_torch.utils.video import read_avi
    from tcs_tpu_torch.utils.visualization import pseudo_color_map

    listing = sorted(os.listdir(video_dir))
    if listing != ["000000.avi"]:
        fail(f"submit_kitti(submission=False) wrote {listing}, not one .avi")
    path = os.path.join(video_dir, listing[0])
    avi = read_avi(path)
    kh, kw = EVAL_TREES["kitti"][1]["height"], EVAL_TREES["kitti"][1]["width"]
    head = (avi.fourcc, avi.fps, avi.width, avi.height, len(avi.frames))
    print(f"submit_kitti video {listing[0]}: {os.path.getsize(path)} bytes, (fourcc, fps, "
          f"width, height, frames) {head}")
    if head != ("MJPG", 2.0, kw, kh, len(disps)):
        fail(f"submit_kitti's video {head} against ('MJPG', 2.0, {kw}, {kh}, {len(disps)})")
    t_dec, worst = [], float("inf")
    for k, (data, disp) in enumerate(zip(avi.frames, disps)):
        t0 = time.perf_counter()
        frame = read_jpeg(data)
        t_dec.append(1e3 * (time.perf_counter() - t0))
        want = pseudo_color_map(disp, vmin=0, vmax=96, kitti_style=True)
        if not np.array_equal(frame, read_jpeg(encode_jpeg(want, 95))):
            fail(f"submit_kitti's video frame {k} is not the encoding of its disparity's map")
        worst = min(worst, psnr(frame, want))
    print(f"submit_kitti video: every frame the port's quality-95 encoding of its "
          f"disparity's pseudo-colour map, bit for bit; lowest PSNR against the map "
          f"{worst:.2f} dB (floor {VIDEO_PSNR_FLOOR}); read_jpeg {kw}x{kh} median "
          f"{float(np.median(t_dec)):.3f} ms a frame on the host of {smi}")
    if worst < VIDEO_PSNR_FLOOR:
        fail(f"submit_kitti's video: a frame {worst:.2f} dB from its map, below the "
             f"{VIDEO_PSNR_FLOOR} dB floor")


# Phase 9, training from files: the trees (frames per sequence at the
# datasets' frame sizes), the CLI runs' lengths and the loader's workers.
TREE_FRAMES = 6
FILE_STEPS = 12  # the SceneFlow recipe from files; medians over steps 3..n
RESUME_STEPS, RESUME_EVERY, SIGTERM_AFTER = 6, 4, 2
FL4_STEPS = 4
LOADER_WORKERS = (1, 4, 8)
LOADER_BATCHES = {1: 2, 4: 4, 8: 6}  # timed after the first, which pays for the start
# Phase 7's step in this process, on the device-resident batch (R) and on the
# loader's (F), in blocks ordered R F, the CLI run from files, F R: the
# resident blocks are the CLI run's baseline, with the host's drift over
# the blocks falling on both sides alike.
BRACKET_STEPS = 8
LOADER_SETTLE_S = 3.0  # the loader fills its prefetch window
# python chip_smoke.py --loader-cores: rounds of blocks, steps a block, the
# worker counts tried.
PROBE_ROUNDS, PROBE_STEPS, PROBE_WORKERS = 3, 5, (3, 4, 6)
STEP_LAUNCHES = {2: {"corr_lookup": 10, "corr_lookup_bwd": 10, "splat_sum": 1, "splat_sum_bwd": 0},
                 4: {"corr_lookup": 20, "corr_lookup_bwd": 20, "splat_sum": 3, "splat_sum_bwd": 0}}


# python -m torch.distributed.run with one process on this machine's card
LAUNCHER = ("-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1")


def train_cli(args, root, name, launcher=()) -> subprocess.Popen:
    """The training CLI in a process group of its own (its loader's workers,
    and under ``launcher`` the launcher's processes, with it)."""
    return subprocess.Popen([sys.executable, *launcher, "-m", "tcs_tpu_torch.cli.train", *args,
                             "--data_root", root, "--checkpoint_dir",
                             os.path.join(root, "ck"), "--name", name],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def step_records(root, name) -> list:
    path = os.path.join(root, "ck", f"{name}_steps.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def run_train_cli(args, root, name, timeout=600, launcher=()) -> list:
    """Run the training CLI to its end; its per-step records."""
    t0 = time.perf_counter()
    proc = train_cli(args, root, name, launcher)
    out, _ = proc.communicate(timeout=timeout)
    with open(os.path.join("runs", f"train_{name}.log"), "w") as f:
        f.write(out)
    print(f"training CLI {name} ({' '.join(args)}): exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.2f} s (log: runs/train_{name}.log)")
    if proc.returncode != 0:
        fail(f"training CLI {name} exited {proc.returncode}:\n{out[-4000:]}")
    return step_records(root, name)


def summarise_steps(tag, recs, batch, frames, smi) -> dict:
    """Medians over steps 3..n; fails on a launch count other than the
    window's or a loss that is not finite."""
    want = STEP_LAUNCHES[frames]
    for r in recs:
        if r["launches"] != want or not np.isfinite(r["live_loss"]):
            fail(f"{tag} step {r['step']}: launches {r['launches']} (want {want}), "
                 f"loss {r['live_loss']}")
    steady = recs[2:]
    med = {k: float(np.median([r[k] for r in steady]))
           for k in ("wall_ms", "step_ms", "data_wait_ms", "h2d_ms")}
    med["frames_per_s"] = batch * frames * 1000 / med["wall_ms"]
    med["peak_gib"] = max(r["peak_gib"] for r in recs)
    print(f"{tag}: {len(recs)} steps, over steps 3-{len(recs)}: median {med['wall_ms']:.2f} "
          f"ms/step, {med['frames_per_s']:.2f} frames/s, data wait {med['data_wait_ms']:.3f} ms, "
          f"H2D {med['h2d_ms']:.3f} ms, step {med['step_ms']:.2f} ms; peak {med['peak_gib']:.3f} "
          f"GiB; launches per step {want}; all steps ms {[round(r['wall_ms'], 1) for r in recs]} "
          f"on {smi}")
    return med


def decode_ms(path) -> tuple:
    """ms per read of an 8-bit RGB PNG through ``read_png`` (zlib and the host
    core) and through the numpy path (zlib and the anti-diagonal unfilter),
    and the two arrays."""
    import struct
    import zlib

    from tcs_tpu_torch.data import png

    def plain():
        chunks = list(png._chunks(open(path, "rb").read(), path))
        width, height = struct.unpack(">II", dict(chunks)[b"IHDR"][:8])
        raw = np.frombuffer(zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT")),
                            np.uint8).reshape(height, -1)
        return png._unfilter_diagonals(raw[:, 1:], raw[:, 0], 3).reshape(height, width, 3)

    times = {}
    for name, fn, reps in (("host", lambda: png.read_png(path), 10), ("plain", plain, 3)):
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            img = fn()
            ms.append(1e3 * (time.perf_counter() - t0))
        times[name] = (float(np.median(ms)), img)
    return times["host"][0], times["plain"][0], times["host"][1], times["plain"][1]


def loader_rate(ds, workers: int, batch: int, batches: int = None) -> float:
    """Samples/s of the loader alone, over ``batches`` batches (by default
    ``LOADER_BATCHES[workers]``) after the first."""
    from tcs_tpu_torch.data.loader import SequenceLoader

    with SequenceLoader(ds, batch, num_workers=workers) as loader:
        it = loader.stream(1)
        next(it)
        t0 = time.perf_counter()
        n = batches or LOADER_BATCHES[workers]
        for _ in range(n):
            next(it)
        rate = n * batch / (time.perf_counter() - t0)
        it.close()
    return rate


def step_timer(cfg):
    """Phase 7's step in this process: a function of (n, batches) that runs n
    steps and returns their ms each, on phase 7's device-resident batch or,
    given a loader's stream, on its batches, each copied to the card within
    its step's time as the trainer copies it."""
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.train import SequenceBatch, make_train_step

    model = TCStereo(cfg.model, seed=0)
    step = make_train_step(model, cfg)
    resident = _synthetic_batch(TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_FRAMES, cfg.seed, "cuda")
    step(resident)["live_loss"].item()  # warm-up

    def timed(n: int, batches=None) -> list:
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = (resident if batches is None
                     else SequenceBatch.from_loader(next(batches)[2], "cuda"))
            step(batch)["live_loss"].item()
            times.append(1e3 * (time.perf_counter() - t0))
        return times

    return timed


def started_stream(loader, timed):
    """The loader's stream after one step on its first batch (the workers'
    start) and a pause that fills its prefetch window: its steady state."""
    batches = loader.stream(1)
    timed(1, batches)
    time.sleep(LOADER_SETTLE_S)
    return batches


def loader_cores_probe(smi: str) -> None:
    """``python chip_smoke.py --loader-cores``: phase 7's step in this
    process on the loader's batches, with the workers sharing the host's
    cores in several ways, each block of steps beside a block on the
    device-resident batch, rounds interleaved so that the host's drift falls
    on every case alike."""
    import tempfile

    from tcs_tpu_torch.config import sceneflow_recipe
    from tcs_tpu_torch.data import datasets, fabricate
    from tcs_tpu_torch.data.loader import SequenceLoader

    tmp_dir = tempfile.TemporaryDirectory(prefix="probe_tree_", dir="runs")
    fabricate.sceneflow_train_tree(tmp_dir.name, frames=TREE_FRAMES)
    cfg = dataclasses.replace(sceneflow_recipe(), data_root=tmp_dir.name)
    ds = datasets.fetch_dataset(cfg)
    timed = step_timer(cfg)
    cpus = sorted(os.sched_getaffinity(0))
    launcher_cpu, worker_cpus = cpus[0], set(cpus[1:])
    cases = {f"{w} workers": (w, False, 0) for w in PROBE_WORKERS}
    cases[f"4 workers on CPUs {sorted(worker_cpus)}, the launching thread on CPU "
          f"{launcher_cpu}"] = (4, True, 0)
    cases["4 workers at nice 10"] = (4, False, 10)
    res = {name: [] for name in ("device-resident batch", *cases)}
    for _ in range(PROBE_ROUNDS):
        for name, (workers, pin, nice) in cases.items():
            with SequenceLoader(ds, cfg.batch_size, seed=cfg.seed, num_workers=workers,
                                pin_memory=True) as loader:
                batches = started_stream(loader, timed)
                for pid in loader._pool._processes:
                    if pin:
                        os.sched_setaffinity(pid, worker_cpus)
                    os.setpriority(os.PRIO_PROCESS, pid, nice)
                if pin:
                    os.sched_setaffinity(0, {launcher_cpu})  # this thread only
                try:
                    res[name] += timed(PROBE_STEPS, batches)
                finally:
                    os.sched_setaffinity(0, cpus)
                    batches.close()
            res["device-resident batch"] += timed(PROBE_STEPS)
    alone = float(np.median(res["device-resident batch"]))
    for name, times in res.items():
        med = float(np.median(times))
        print(f"loader cores: phase 7's step (B{TRAIN_B} {TRAIN_H}x{TRAIN_W}) on the "
              f"{'loader' if name in cases else ''} {name}: median {med:.2f} ms over "
              f"{len(times)} steps, {alone / med:.3f} of the device-resident batch's frames/s; "
              f"ms {[round(t, 1) for t in times]} on {smi}")
    tmp_dir.cleanup()


def host_description() -> str:
    """The host's CPUs as the loader's workers see them."""
    siblings = "/sys/devices/system/cpu/cpu0/topology/thread_siblings_list"
    per_core = open(siblings).read().strip() if os.path.exists(siblings) else "unknown"
    shm = shutil.disk_usage("/dev/shm").total / 2**30 if os.path.isdir("/dev/shm") else 0.0
    return (f"{os.cpu_count()} CPUs (CPU 0 shares its core with {per_core}), "
            f"/dev/shm {shm:.1f} GiB")


def phase_training_from_files(smi: str, train_ms: float) -> dict:
    """The three recipes trained from fabricated trees on disk through the
    training CLI, with the decode, the loader, SIGTERM and resume; returns
    the launch counts of the CLI runs, summed."""
    import signal
    import tempfile

    from tcs_tpu_torch.config import sceneflow_recipe
    from tcs_tpu_torch.data import datasets, fabricate
    from tcs_tpu_torch.data.loader import SequenceLoader
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.utils.checkpoint import CheckpointManager, load_weights

    print(f"training from files: host {host_description()}")
    tmp_dir = tempfile.TemporaryDirectory(prefix="train_trees_", dir="runs")
    root = tmp_dir.name
    t_phase = t0 = time.perf_counter()
    fabricate.sceneflow_train_tree(root, frames=TREE_FRAMES)
    fabricate.tartanair_train_tree(root, frames=TREE_FRAMES)
    fabricate.kitti_raw_tree(root, frames=TREE_FRAMES)
    subprocess.run([sys.executable, "-m", "tcs_tpu_torch.data.kitti_raw_pose", "--root",
                    os.path.join(root, "kitti_raw")], check=True, capture_output=True)
    print(f"training trees (SceneFlow 540x960, TartanAir 480x640, KITTI raw 375x1242; "
          f"{TREE_FRAMES} frames a sequence, Paeth-filtered PNGs) written in "
          f"{time.perf_counter() - t0:.2f} s")

    png_path = os.path.join(root, "FlyingThings3D", "frames_cleanpass", "TRAIN", "A", "0000",
                            "left", "0000.png")
    host_ms, plain_ms, a, b = decode_ms(png_path)
    print(f"read_png 540x960 RGB, Paeth rows: host core {host_ms:.3f} ms, numpy path "
          f"{plain_ms:.3f} ms per call, equal {np.array_equal(a, b)}, on {smi}")
    if a.shape != (540, 960, 3) or not np.array_equal(a, b):
        fail("read_png through the host core differs from the numpy path")

    cfg = dataclasses.replace(sceneflow_recipe(), data_root=root)
    ds = datasets.fetch_dataset(cfg)
    consume = TRAIN_B * 1000 / train_ms
    for workers in LOADER_WORKERS:
        rate = loader_rate(ds, workers, cfg.batch_size)
        print(f"loader alone, SceneFlow recipe (B{cfg.batch_size}, 2 frames, 540x960 files, "
              f"{len(ds)} samples), {workers} worker processes: {rate:.2f} samples/s; "
              f"phase 7's step consumes {consume:.2f} samples/s; on {smi}")
    print(f"training from files: trees, decode and loader took "
          f"{time.perf_counter() - t_phase:.1f} s")

    launches = dict.fromkeys(STEP_LAUNCHES[2], 0)

    def add(recs):
        for r in recs:
            for k in launches:
                launches[k] += r["launches"][k]

    # Phase 7's step in this process on the resident batch (R) and on the
    # loader's batches (F), around the CLI run from files: R F CLI F R.
    timed = step_timer(cfg)
    bracket = timed(BRACKET_STEPS)
    with SequenceLoader(ds, cfg.batch_size, seed=cfg.seed, num_workers=cfg.num_workers,
                        pin_memory=True) as loader:
        batches = started_stream(loader, timed)
        fed = timed(BRACKET_STEPS, batches)
        sf = run_train_cli(["--recipe", "sceneflow", "--num_steps", str(FILE_STEPS)], root, "sf")
        fed += timed(BRACKET_STEPS, batches)
        batches.close()
    bracket += timed(BRACKET_STEPS)
    del timed  # its model and batch; the card's memory goes to the CLI runs below
    torch.cuda.empty_cache()
    add(sf)
    med = summarise_steps("SceneFlow recipe from files (B4 320x720 fl2)", sf, 4, 2, smi)
    resident_ms, fed_ms = float(np.median(bracket)), float(np.median(fed))
    fps = lambda ms: TRAIN_B * TRAIN_FRAMES * 1000 / ms  # noqa: E731
    print(f"phase 7's step in this process, {2 * BRACKET_STEPS} steps each, before and after "
          f"the CLI run: on the device-resident batch median {resident_ms:.2f} ms/step "
          f"({fps(resident_ms):.2f} frames/s), ms {[round(t, 1) for t in bracket]}; on the "
          f"{cfg.num_workers}-process loader's batches median {fed_ms:.2f} ms/step "
          f"({fps(fed_ms):.2f} frames/s, {fps(fed_ms) / fps(resident_ms):.3f} of the resident "
          f"batch's), ms {[round(t, 1) for t in fed]}; on {smi}")
    for what, ms in ((f"phase 7 (device-resident batch, {train_ms:.2f} ms/step", train_ms),
                     (f"the device-resident step around it (median {resident_ms:.2f} ms/step",
                      resident_ms)):
        print(f"SceneFlow from files against {what}, {fps(ms):.2f} frames/s): "
              f"{med['frames_per_s'] / fps(ms):.3f} of its frames/s (goal >= 0.85)")
    print(f"SceneFlow from files: median data wait {med['data_wait_ms'] / med['wall_ms']:.4f} "
          f"of the median step (goal < 0.10)")

    # SIGTERM to the CLI's process group, its workers with it, as a job
    # scheduler preempts, after step SIGTERM_AFTER; the same command resumes.
    # Both halves and an uninterrupted run of the same steps ("det") train
    # under --deterministic, without which cuDNN does not promise exact
    # resume: the stopped-and-resumed run must take the same data as the
    # uninterrupted runs, and the same losses, gradient norms and last
    # weights bit for bit.
    resume_args = ["--recipe", "sceneflow", "--num_steps", str(RESUME_STEPS),
                   "--validation_frequency", str(RESUME_EVERY), "--deterministic"]
    det = run_train_cli(resume_args, root, "det")
    proc = train_cli(resume_args, root, "sig")
    while len(step_records(root, "sig")) < SIGTERM_AFTER and proc.poll() is None:
        time.sleep(0.05)
    os.killpg(proc.pid, signal.SIGTERM)
    out, _ = proc.communicate(timeout=300)
    with open(os.path.join("runs", "train_sig_stopped.log"), "w") as f:
        f.write(out)
    first = step_records(root, "sig")
    k = first[-1]["step"]
    mgr = CheckpointManager(os.path.join(root, "ck", "sig"))
    print(f"SIGTERM to the process group after step {SIGTERM_AFTER}'s record: exit {proc.returncode}, last step {k}, "
          f"newest checkpoint {mgr.latest_step()}")
    if proc.returncode != 0 or mgr.latest_step() != k or k >= RESUME_STEPS:
        fail(f"SIGTERM: exit {proc.returncode}, last step {k}, checkpoint {mgr.latest_step()}")
    model = TCStereo(cfg.model, seed=1)
    load_weights(model, mgr.path(k))
    saved = torch.load(mgr.path(k), map_location="cpu", weights_only=True)["model"]
    if not all(torch.equal(v.cpu(), saved[n]) for n, v in model.state_dict().items()):
        fail("the checkpoint's weights do not reload bit for bit")
    del model
    both = run_train_cli(resume_args, root, "sig")
    pos = lambda r: (r["step"], r["epoch"], r["batch"], r["index"])  # noqa: E731
    want = [pos(r) for r in sf if r["step"] <= RESUME_STEPS]
    print(f"resumed at step {both[len(first)]['step'] if len(both) > k else None}: (step, "
          f"epoch, batch, indices) before the stop and after the resume "
          f"{[pos(r) for r in both]}; the uninterrupted run's {want}; weights reloaded bit "
          f"for bit")
    if [pos(r) for r in both] != want or [pos(r) for r in det] != want:
        fail("the stopped and resumed run's data differs from the uninterrupted run's")
    exact = {key: [r[key] for r in both] == [r[key] for r in det]
             for key in ("live_loss", "grad_norm")}
    last = [torch.load(CheckpointManager(os.path.join(root, "ck", name)).path(RESUME_STEPS),
                       map_location="cpu", weights_only=True)["model"] for name in ("sig", "det")]
    exact["weights"] = last[0].keys() == last[1].keys() and all(
        torch.equal(v, last[1][n]) for n, v in last[0].items())
    for key in ("live_loss", "grad_norm"):
        print(f"--deterministic, stopped at step {k} and resumed, against uninterrupted: "
              f"{key} {[r[key] for r in both]} against {[r[key] for r in det]}")
    print(f"--deterministic resume, bit for bit against the uninterrupted run: {exact} "
          f"(step {RESUME_STEPS}'s checkpoint for the weights)")
    if not all(exact.values()):
        fail(f"--deterministic: the resumed run is not the uninterrupted run bit for bit: "
             f"{exact}")
    det_med = summarise_steps("SceneFlow recipe from files under --deterministic", det, 4, 2,
                              smi)
    print(f"SceneFlow recipe from files, median over steps 3..n: {med['wall_ms']:.2f} ms/step "
          f"without --deterministic ({len(sf)} steps), {det_med['wall_ms']:.2f} ms/step with "
          f"it ({len(det)} steps), {det_med['wall_ms'] / med['wall_ms']:.3f}x; on {smi}")
    add(det)
    add(both)
    # The bf16 step in this process under the flag: the library calls torch
    # reports as nondeterministic on the card (none is needed for the exact
    # resume above, which the two runs prove).
    from tcs_tpu_torch import device as device_lib
    from tcs_tpu_torch.train import make_train_step

    model = TCStereo(cfg.model, seed=0)
    step = make_train_step(model, cfg)
    with device_lib.deterministic():
        racy = nondeterministic_ops(
            step, _synthetic_batch(TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_FRAMES, cfg.seed, "cuda"))
    print(f"bf16 SceneFlow step under --deterministic: library calls torch reports as "
          f"nondeterministic: {racy or 'none'}")
    del model, step
    torch.cuda.empty_cache()

    # The fl4 recipes; KITTI raw starts from the SceneFlow run's last weights.
    start = CheckpointManager(os.path.join(root, "ck", "sf"))
    for recipe, name, extra in (
            ("TartanAir", "ta", []),
            ("kitti_raw", "kr", ["--restore_ckpt", start.path(start.latest_step())])):
        recs = run_train_cli(["--recipe", recipe, "--num_steps", str(FL4_STEPS), *extra], root,
                             name)
        add(recs)
        H, W = FL4_CROPS[recipe]
        summarise_steps(f"{recipe} recipe from files (B{TRAIN_B} {H}x{W} fl4)", recs, TRAIN_B, 4,
                        smi)
    print(f"training from files: phase 9 took {time.perf_counter() - t_phase:.1f} s")
    # phase 10 trains under the launcher on the same tree
    return launches, dict(tmp_dir=tmp_dir, root=root, sf=sf)


# Phase 10, data parallelism.
DDP_TIMED = 3  # (a): timed steps of each of the plain and the DDP step, after one each
DDP_GRAD_RTOL = 1e-2  # (b): whole gradient against one process, kinks free (CPU tests' bound)
DDP_LOSS_RTOL = 1e-3  # (b): the loss, relative: the port's loss bound (PERF.md section 2)
DDP_BITWISE_RTOL = 1e-6  # (a) where the card is not bitwise repeatable, of the largest entry
ALLREDUCE_REPS = 5


def _fresh_store(name: str) -> str:
    """A path for a FileStore rendezvous under runs/: none there yet."""
    path = os.path.abspath(os.path.join("runs", f"{name}_{os.getpid()}"))
    if os.path.exists(path):
        os.remove(path)
    return path


def _flat_grad(model) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def ddp_world_one(smi: str, train_ms: float) -> dict:
    """(a) Phase 7's step under DDP at world 1 over NCCL in this process,
    from phase 7's weights on its batch, against the plain step; returns
    the kernels' launches of the DDP steps."""
    from tcs_tpu_torch.config import sceneflow_recipe
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.ops import _kernels
    from tcs_tpu_torch.parallel import mesh
    from tcs_tpu_torch.train import make_train_step

    store = _fresh_store("ddp_store")
    mesh.initialize_distributed(f"file://{store}", 1, 0, device="cuda")
    try:
        cfg = sceneflow_recipe()
        batch = _synthetic_batch(TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_FRAMES, cfg.seed, "cuda")
        plain_model, ddp_model = TCStereo(cfg.model, seed=0), TCStereo(cfg.model, seed=0)
        plain, ddp = make_train_step(plain_model, cfg), make_train_step(mesh.wrap(ddp_model), cfg)
        print(f"data parallel (a): DDP over {torch.distributed.get_backend()} at world "
              f"{mesh.world_size()}, sum hook, find_unused_parameters")

        def timed(step, n):
            times = []
            for _ in range(n):
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                metrics = step(batch)
                stop.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(stop))
            return metrics, times

        def state(model):  # the gradients and the updated weights after a step
            return (_flat_grad(model), torch.cat([p.detach().reshape(-1)
                                                  for p in model.parameters()]))

        # The first step of each, from the same weights on the same batch.
        want, _ = timed(plain, 1)
        grads = [state(plain_model)]
        _kernels.reset_launches()
        got, warm = timed(ddp, 1)
        grads.append(state(ddp_model))
        _, ddp_times = timed(ddp, DDP_TIMED)
        counts = dict(_kernels.launches)
        _, plain_times = timed(plain, DDP_TIMED)
        steps = 1 + DDP_TIMED
        per_step = {k: v / steps for k, v in counts.items()}
        print(f"data parallel (a): launches {counts} over {steps} DDP steps, {per_step} a step; "
              f"on {smi}")
        if per_step != STEP_LAUNCHES[TRAIN_FRAMES]:
            fail(f"DDP step launches {per_step} a step, not {STEP_LAUNCHES[TRAIN_FRAMES]}")
        same_metrics = {k: float(got[k]) == float(want[k]) for k in want}
        print(f"data parallel (a): metrics equal bit for bit {all(same_metrics.values())} "
              f"({[k for k, v in same_metrics.items() if not v]} differ); live_loss "
              f"{float(got['live_loss']):.6f} against {float(want['live_loss']):.6f}")
        exact = all(same_metrics.values()) and all(torch.equal(a, b) for a, b in
                                                   zip(grads[0], grads[1]))
        if not exact:
            gap = max(_rel_gap(b, a) for a, b in zip(grads[0], grads[1]))
            metric_gap = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-12)
                             for k in want)
            again_model = TCStereo(cfg.model, seed=0)  # is the plain step repeatable?
            again, _ = timed(make_train_step(again_model, cfg), 1)
            repeat = max(_rel_gap(b, a) for a, b in zip(grads[0], state(again_model)))
            print(f"data parallel (a): not bit for bit: gradients and weights {gap:.3e} of their "
                  f"largest entry, metrics {metric_gap:.3e} relative (bound {DDP_BITWISE_RTOL:.0e}); "
                  f"a second plain step from the same weights is {repeat:.3e} off the first, "
                  f"live_loss {float(again['live_loss']):.6f}")
            if not (gap <= DDP_BITWISE_RTOL and metric_gap <= DDP_BITWISE_RTOL):
                fail(f"DDP step at world 1 against the plain step: {gap}, {metric_gap}")
        else:
            print("data parallel (a): the DDP step's losses, metrics, gradients and updated "
                  "weights equal the plain step's bit for bit")
        med = lambda t: float(np.median(t))  # noqa: E731
        print(f"data parallel (a): DDP step B{TRAIN_B} {TRAIN_H}x{TRAIN_W} fl{TRAIN_FRAMES} iters "
              f"{TRAIN_ITERS} median {med(ddp_times):.2f} ms/step (first {warm[0]:.2f}; ms "
              f"{[round(t, 2) for t in ddp_times]}), the plain step after it "
              f"{med(plain_times):.2f} ms/step (ms {[round(t, 2) for t in plain_times]}); "
              f"phase 7 {train_ms:.2f} ms/step; DDP / plain {med(ddp_times) / med(plain_times):.3f}"
              f"; on {smi}")
        return counts
    finally:
        mesh.destroy()
        if os.path.exists(store):
            os.remove(store)


def _fp32_recipe():
    from tcs_tpu_torch.config import ModelConfig, sceneflow_recipe

    return dataclasses.replace(sceneflow_recipe(),
                               model=ModelConfig(mixed_precision=False, corr_dtype="float32"))


def _pair_rank(rank: int, store: str, out: str, backend: str, devices) -> None:
    """(b), (e): one of two ranks, each on 4 of one batch of 8 (fp32, TF32
    off): two steps (the first held against one process, the second timed),
    then the all-reduce of a gradient's size alone."""
    from tcs_tpu_torch.data.synthetic import make_clips
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.parallel import mesh
    from tcs_tpu_torch.train import SequenceBatch, make_train_step

    dev = torch.device(devices[rank])
    mesh.initialize_distributed(f"file://{store}", 2, rank, backend=backend, device=dev)
    try:
        with tf32_off():
            cfg = _fp32_recipe()
            model = TCStereo(cfg.model, device=dev, seed=0)
            step = make_train_step(mesh.wrap(model), cfg)
            clips = make_clips(2 * TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_FRAMES, cfg.seed)
            batch = SequenceBatch.from_numpy(clips[rank * TRAIN_B:(rank + 1) * TRAIN_B], dev)
            torch.cuda.reset_peak_memory_stats(dev)
            metrics = {k: float(v) for k, v in step(batch).items()}
            grad = _flat_grad(model).cpu()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            step(batch)["live_loss"].item()
            step_ms = 1e3 * (time.perf_counter() - t0)
            buf = torch.zeros(grad.numel(), device=dev)
            times = []
            for _ in range(ALLREDUCE_REPS + 1):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                mesh.all_reduce_sum(buf)
                torch.cuda.synchronize(dev)
                times.append(1e3 * (time.perf_counter() - t0))
        torch.save(dict(metrics=metrics, grad=grad, step_ms=step_ms,
                        allreduce_ms=float(np.median(times[1:])), bytes=buf.numel() * 4,
                        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30),
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh.destroy()


def ddp_pair(smi: str, backend: str, devices, want: dict, label: str) -> None:
    """Two ranks (``_pair_rank``) against one process's step on the 8."""
    import torch.multiprocessing as tmp

    out = os.path.abspath(os.path.join("runs", f"ddp_pair_{backend}"))
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t0 = time.perf_counter()
    tmp.spawn(_pair_rank, args=(_fresh_store(f"ddp_pair_{backend}_store"), out, backend,
                                devices), nprocs=2, join=True)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    equal = torch.equal(ranks[0]["grad"], ranks[1]["grad"])
    gap = _rel_gap(ranks[0]["grad"], want["grad"])
    loss_gap = abs(ranks[0]["metrics"]["live_loss"] - want["metrics"]["live_loss"]) / abs(
        want["metrics"]["live_loss"])
    print(f"data parallel {label}: {2 * TRAIN_B} samples as 2 ranks x {TRAIN_B} on {devices} over "
          f"{backend} ({time.perf_counter() - t0:.1f} s with the processes' start): the ranks' "
          f"gradients equal bit for bit {equal}; against one process's step on the {2 * TRAIN_B}: "
          f"whole gradient {gap:.3e} of its largest entry (bound {DDP_GRAD_RTOL:.0e}), live_loss "
          f"{ranks[0]['metrics']['live_loss']:.6f} against {want['metrics']['live_loss']:.6f} "
          f"({loss_gap:.2e} relative, bound {DDP_LOSS_RTOL:.0e}); on {smi}")
    for r, res in enumerate(ranks):
        print(f"data parallel {label}, rank {r}: step {res['step_ms']:.2f} ms (the second, host "
              f"clock), all-reduce of {res['bytes'] / 1e6:.1f} MB of fp32 gradients "
              f"{res['allreduce_ms']:.2f} ms, peak {res['peak_gib']:.3f} GiB; on {smi}")
    if not (equal and gap <= DDP_GRAD_RTOL and loss_gap <= DDP_LOSS_RTOL):
        fail(f"data parallel {label}: ranks equal {equal}, gradient {gap}, loss {loss_gap}")


def one_process_on_eight(smi: str) -> dict:
    """One process's step on the batch of 8 that (b) splits, fp32, TF32 off."""
    from tcs_tpu_torch.data.synthetic import make_clips
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.train import SequenceBatch, make_train_step

    with tf32_off():
        cfg = _fp32_recipe()
        model = TCStereo(cfg.model, seed=0)
        batch = SequenceBatch.from_numpy(
            make_clips(2 * TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_FRAMES, cfg.seed), "cuda")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in make_train_step(model, cfg)(batch).items()}
        ms = 1e3 * (time.perf_counter() - t0)
        want = dict(metrics=metrics, grad=_flat_grad(model).cpu())
    print(f"data parallel (b): one process, B{2 * TRAIN_B} {TRAIN_H}x{TRAIN_W} fp32: first step "
          f"{ms:.2f} ms, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; on {smi}")
    del model, batch
    torch.cuda.empty_cache()
    return want


def ddp_launcher_cli(smi: str, train_tree: dict) -> dict:
    """(c) The training CLI under the launcher on phase 9's SceneFlow tree:
    a SIGTERM to the launcher's process group after the second step record,
    then the same command to its end; returns the steps' launches."""
    import signal

    from tcs_tpu_torch.utils.checkpoint import CheckpointManager

    root, name = train_tree["root"], "ddp_sig"
    args = ["--recipe", "sceneflow", "--num_steps", str(RESUME_STEPS),
            "--validation_frequency", str(RESUME_EVERY)]
    t0 = time.perf_counter()
    proc = train_cli(args, root, name, LAUNCHER)
    while len(step_records(root, name)) < SIGTERM_AFTER and proc.poll() is None:
        time.sleep(0.05)
    os.killpg(proc.pid, signal.SIGTERM)
    out, _ = proc.communicate(timeout=300)
    with open(os.path.join("runs", f"train_{name}_stopped.log"), "w") as f:
        f.write(out)
    first = step_records(root, name)
    k = first[-1]["step"] if first else None
    mgr = CheckpointManager(os.path.join(root, "ck", name))
    clean = (f"SIGTERM: checkpointing at step {k} and stopping" in out
             and f"Stopped at step {k} " in out)
    # torch.distributed.run turns a SIGTERM of its own into an exit code of 1
    # once its processes have stopped; the worker's exit is the trainer's.
    forwarded = "death signal" in out or "SignalException" in out
    print(f"data parallel (c): training CLI under python -m torch.distributed.run "
          f"--nproc_per_node 1 (NCCL), SIGTERM to the launcher's process group after step "
          f"{SIGTERM_AFTER}'s record: launcher exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s, the trainer stopped cleanly at step {k} {clean}, "
          f"newest checkpoint {mgr.latest_step()}; on {smi}")
    if not (clean and mgr.latest_step() == k and k < RESUME_STEPS
            and (proc.returncode == 0 or (proc.returncode == 1 and forwarded))):
        fail(f"SIGTERM under the launcher: exit {proc.returncode}, clean {clean}, last step {k}, "
             f"checkpoint {mgr.latest_step()}:\n{out[-4000:]}")
    both = run_train_cli(args, root, name, launcher=LAUNCHER)
    pos = lambda r: (r["step"], r["epoch"], r["batch"], r["index"])  # noqa: E731
    want = [pos(r) for r in train_tree["sf"] if r["step"] <= RESUME_STEPS]
    print(f"data parallel (c): resumed under the launcher; (step, epoch, batch, indices) "
          f"{[pos(r) for r in both]}; phase 9's uninterrupted run {want}")
    if [pos(r) for r in both] != want:
        fail("the stopped and resumed run under the launcher took other data")
    launches = STEP_LAUNCHES[TRAIN_FRAMES]
    for r in both:
        if r["launches"] != launches or not np.isfinite(r["live_loss"]):
            fail(f"(c) step {r['step']}: launches {r['launches']} (want {launches}), "
                 f"loss {r['live_loss']}")
    # Two processes' records: each one's first step pays for its start.
    print(f"data parallel (c): launches {launches} on each step; ms between the steps' "
          f"records {[round(r['wall_ms'], 1) for r in both]}, peak "
          f"{max(r['peak_gib'] for r in both):.3f} GiB; on {smi}")
    return {n: sum(r["launches"][n] for r in both) for n in launches}


def ddp_launcher_eval(smi: str, eval_tree: dict) -> None:
    """(d) The evaluation CLI with --sharded under the launcher on phase 8's
    TartanAir tree and weights, against phase 8's in-process results."""
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, *LAUNCHER, "-m", "tcs_tpu_torch.cli.evaluate",
                          "--dataset", "TartanAir", "--data_root", eval_tree["root"],
                          "--restore_ckpt", eval_tree["pth"], "--valid_iters", str(EVAL_ITERS),
                          "--sharded"], capture_output=True, text=True, timeout=600)
    with open(os.path.join("runs", "eval_sharded.log"), "w") as f:
        f.write(cli.stdout + cli.stderr)
    print(f"data parallel (d): evaluation CLI --sharded under the launcher: exit "
          f"{cli.returncode} in {time.perf_counter() - t0:.2f} s (log: runs/eval_sharded.log)")
    if cli.returncode != 0:
        fail(f"the sharded evaluation CLI exited {cli.returncode}:\n{cli.stderr[-4000:]}")
    got = json.loads(cli.stdout.strip().splitlines()[-1])
    want = eval_tree["results"]
    print(f"data parallel (d): {json.dumps(got)}; equal to phase 8's in-process results bit "
          f"for bit {got == want}; on {smi}")
    if got != want:
        fail(f"the sharded evaluation CLI's results {got} differ from phase 8's {want}")


def phase_data_parallel(smi: str, train_ms: float, eval_tree: dict, train_tree: dict) -> dict:
    """Phase 10; returns the kernels' launches of the DDP path's runs, (a)'s
    steps and (c)'s CLI steps."""
    t_phase = time.perf_counter()
    counts = ddp_world_one(smi, train_ms)
    want = one_process_on_eight(smi)
    ddp_pair(smi, "gloo", ("cuda:0", "cuda:0"), want,
             "(b) two ranks on one card over Gloo: not a scaling number")
    cli_counts = ddp_launcher_cli(smi, train_tree)
    ddp_launcher_eval(smi, eval_tree)
    if torch.cuda.device_count() >= 2:
        ddp_pair(smi, "nccl", ("cuda:0", "cuda:1"), want, "(e) across two cards over NCCL")
    else:
        print(f"ddp across cards: not run ({torch.cuda.device_count()} card)")
    train_tree["tmp_dir"].cleanup()  # phase 13 evaluates on eval_tree's TartanAir tree
    print(f"data parallel: phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return {k: counts[k] + cli_counts[k] for k in counts}


# Phase 11, trained weights and convergence.


def _fixture_clips():
    from tcs_tpu_torch.data.synthetic import SyntheticStereoSequence

    ds = SyntheticStereoSequence(n_samples=FIXTURE_CLIPS, frame_length=2, height=FIXTURE_H,
                                 width=FIXTURE_W, layered_frac=1.0)
    return [ds.load_sample(ci, np.random.default_rng(10_000 + ci))
            for ci in range(FIXTURE_CLIPS)]


def _trained_frames(name, clips, occluded_right_view):
    """(a) and (b) for one config: per device, each clip's frame-0 and
    frame-1 flows on its own carry, frame 1 on the card from the CPU's
    frame-0 state, and on the card the occluded frame 1 carried and reset."""
    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.models import CameraParams, TCStereo, TemporalState
    from tcs_tpu_torch.utils.checkpoint import load_params_npz

    cfg = ModelConfig(**FIXTURE_CONFIGS[name])
    models = {dev: load_params_npz(TCStereo(cfg, device=dev), FIXTURE) for dev in ("cuda", "cpu")}
    res = {"flows": {"cuda": [], "cpu": []}, "from_cpu_state": [], "occluded": []}
    for s in clips:
        def run(dev, t, state, img2=None):
            def x(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=dev)[None]
            cam = CameraParams(K=x(s["K"]), baseline=x(s["baseline"]))
            out = models[dev](x(s["image1"][t]), x(s["image2"][t] if img2 is None else img2),
                              state, cam, x(s["T"][t]), iters=FIXTURE_ITERS)
            return out.flow[0, ..., 0].cpu().numpy(), out.new_state

        states = {}
        for dev in ("cuda", "cpu"):
            state = TemporalState.zeros(1, FIXTURE_H, FIXTURE_W, cfg, device=dev)
            flows = []
            for t in range(2):
                flow, state = run(dev, t, state)
                flows.append(flow)
                if t == 0:
                    states[dev] = state
            res["flows"][dev].append(flows)
        cpu_state = states["cpu"]
        on_card = dataclasses.replace(
            cpu_state, disp_q=cpu_state.disp_q.cuda(), fmap1=cpu_state.fmap1.cuda(),
            T_prev=cpu_state.T_prev.cuda(), net_list=tuple(n.cuda() for n in cpu_state.net_list))
        res["from_cpu_state"].append(run("cuda", 1, on_card)[0])
        img2, (y0, y1, x0, x1) = occluded_right_view(s, 1)
        errs = {}
        for key, state in (("carried", states["cuda"]),
                           ("reset", TemporalState.zeros(1, FIXTURE_H, FIXTURE_W, cfg,
                                                         device="cuda"))):
            flow, _ = run("cuda", 1, state, img2)
            errs[key] = float(np.abs(flow - s["flow"][1][..., 0])[y0:y1, x0:x1].mean())
        res["occluded"].append(errs)
    res["model"] = models["cuda"]
    return res


def load_file(relpath: str, name: str):
    """The module in the file ``relpath`` of this checkout, loaded by path
    (not through ``sys.path``, which may put another tree's package first)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _load_script(name: str):
    return load_file(os.path.join("scripts", name + ".py"), name)


def phase_trained_weights(smi: str) -> dict:
    """Phase 11; returns the launch counts of the phase."""
    from tcs_tpu_torch.ops import _kernels
    from tcs_tpu_torch.utils.checkpoint import save_params_npz

    t_phase = time.perf_counter()
    conv = _load_script("torch_convergence_synthetic")
    clips = _fixture_clips()
    _kernels.reset_launches()
    for name in FIXTURE_CONFIGS:
        with tf32_off() if name == "fp32" else contextlib.nullcontext():
            res = _trained_frames(name, clips, conv.occluded_right_view)
        for ci in range(FIXTURE_CLIPS):
            for t in range(2):
                d = np.abs(res["flows"]["cuda"][ci][t] - res["flows"]["cpu"][ci][t])
                print(f"trained weights (a) [{name}] clip {ci} frame {t}, card against CPU, "
                      f"each on its own carry: max|dflow| {d.max():.3e} mean {d.mean():.3e} px")
                if name == "fp32" and t == 0 and not d.max() <= TRAINED_TOL:
                    fail(f"trained weights, fp32, clip {ci} frame 0: card {d.max()} px from "
                         "the CPU")
            d = np.abs(res["from_cpu_state"][ci] - res["flows"]["cpu"][ci][1])
            print(f"trained weights (a) [{name}] clip {ci} frame 1 from the CPU's frame-0 state: "
                  f"max|dflow| {d.max():.3e} mean {d.mean():.3e} px (tol {TRAINED_TOL} in fp32)")
            if name == "fp32" and not d.max() <= TRAINED_TOL:
                fail(f"trained weights, fp32, clip {ci} frame 1 from one state: card {d.max()} px "
                     "from the CPU")
        carried = float(np.mean([e["carried"] for e in res["occluded"]]))
        reset = float(np.mean([e["reset"] for e in res["occluded"]]))
        print(f"trained weights (b) [{name}] on the card, occluded frame 1, iters "
              f"{FIXTURE_ITERS}: carried {carried:.4f} px, reset {reset:.4f} px (per clip "
              f"{res['occluded']})")
        if not carried < reset:
            fail(f"trained weights [{name}]: the carried state ({carried}) does not beat a "
                 f"reset ({reset})")
        if name == "fp32":
            os.makedirs("runs", exist_ok=True)
            path = os.path.join("runs", "trained_roundtrip.npz")
            save_params_npz(res["model"], path)
            with np.load(path) as mine, np.load(FIXTURE) as theirs:
                same = sorted(mine.files) == sorted(theirs.files) and all(
                    np.array_equal(mine[k].view(np.uint16), theirs[k].view(np.uint16))
                    for k in theirs.files)
            print(f"trained weights (c) save_params_npz of the loaded weights: "
                  f"{len(theirs.files)} arrays, bit for bit with the fixture: {same}")
            if not same:
                fail("save_params_npz does not give back the fixture's arrays")

    args = conv.parse_args([])
    t0 = time.perf_counter()
    res = conv.run(args)
    losses = [r["loss"] for r in res["rows"]]
    per_step = {k: v / args.steps for k, v in res["launches"].items()}
    want = {"corr_lookup": 2 * args.iters, "corr_lookup_bwd": 2 * args.iters, "splat_sum": 1,
            "splat_sum_bwd": 0}
    print(f"convergence (d): {args.steps} steps at B1 {args.height}x{args.width} fl2 iters "
          f"{args.iters}, {res['train_seconds'] / args.steps:.4f} s/step (host clock, the "
          f"loader included), launches a step {per_step} expected {want}; first-{res['k']} "
          f"EPE {res['first_epe']:.4f} px, last-{res['k']} EPE {res['final_epe']:.4f} px "
          f"(target < {args.epe_target}) on {smi}")
    for key, r in res["temporal"].items():
        print(f"convergence (d) temporal {key}: carried {r['carried']:.4f} px, reset "
              f"{r['reset']:.4f} px")
    print(f"convergence (d): {time.perf_counter() - t0:.1f} s "
          f"({res['eval_seconds']:.1f} s of it the temporal evaluation)")
    if per_step != want:
        fail(f"convergence launches a step {per_step} != {want}")
    if not all(np.isfinite(losses)):
        fail("a convergence loss is not finite")
    if not res["final_epe"] < args.epe_target:
        fail(f"convergence: last-{res['k']} EPE {res['final_epe']} px, target {args.epe_target}")
    for key in ("iters1_clean", f"iters{args.iters}_occluded"):
        r = res["temporal"][key]
        if not r["carried"] < r["reset"]:
            fail(f"convergence {key}: carried {r['carried']} does not beat reset {r['reset']}")
    counts = dict(_kernels.launches)
    print(f"trained weights and convergence: phase 11 took {time.perf_counter() - t_phase:.1f} s, "
          f"launches {counts}")
    return counts


# Phase 12: the committed JPEG fixtures, a FallingThings tree at its own
# frame size (scenes, pairs each), and the traces of phase 4's main path
# (frames after one untraced) and of phase 7's training step (one step after
# one untraced), with the kernels each hand kernel's wrapper launches once.
JPEG_FIXTURES = os.path.join("tests", "fixtures", "jpeg")
FT_SCENES = ("single/002_master_chef_can_16k/kitchen_0", "mixed/kitchen_1")
FT_FRAMES, FT_W, FT_H = 2, 960, 540
TRACE_FRAMES, TRACE_STEPS = 3, 1
ONE_KERNEL_PER_LAUNCH = {"corr_lookup": "corr_lookup_kernel",
                         "corr_lookup_bwd": "corr_lookup_bwd_kernel",
                         "splat_sum": "splat_sum_gather_kernel"}


def traced(tag: str, logdir: str, model, run, units: int, unit: str) -> tuple:
    """``run()`` under ``profiling.trace`` with the model's module ranges,
    the launch counts read around it; the trace's summary, printed, and the
    counts. Each hand kernel's events in ``by_op`` are held to its count."""
    from tcs_tpu_torch.ops import _kernels
    from tcs_tpu_torch.utils.profiling import trace
    from tcs_tpu_torch.utils.trace_summary import print_summary, summarize_trace

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(logdir, model):
        _kernels.reset_launches()
        run()
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
    t1 = time.perf_counter()
    summary = summarize_trace(logdir)
    t2 = time.perf_counter()
    print(f"trace [{tag}]: traced and written in {t1 - t0:.2f} s, summarised in "
          f"{t2 - t1:.2f} s; device {summary.total_ms / units:.3f} ms and "
          f"{summary.events / units:.1f} device events a {unit}; no module "
          f"{100 * summary.unattributed_ms / max(summary.total_ms, 1e-9):.2f} % of the device "
          f"time; top-level ranges {summary.jit_ms}")
    print_summary(summary, units, top=8)
    for name, stem in ONE_KERNEL_PER_LAUNCH.items():
        events = sum(n for op, n in summary.launches.items() if stem in op)
        print(f"trace [{tag}]: {stem} events {events}, {name} launches {counts[name]}")
        if events != counts[name]:
            fail(f"trace [{tag}]: {events} {stem} events against {counts[name]} launches")
    return summary, counts


def phase_jpeg_and_trace(smi: str) -> dict:
    """Phase 12; returns the launch counts of the two traced paths, summed."""
    import glob
    import hashlib
    import tempfile

    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch.config import sceneflow_recipe
    from tcs_tpu_torch.data import datasets, fabricate
    from tcs_tpu_torch.data.frame_utils import read_image
    from tcs_tpu_torch.data.jpeg import encode_jpeg, read_jpeg
    from tcs_tpu_torch.data.loader import SequenceLoader
    from tcs_tpu_torch.evaluate import TemporalEvaluator
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.train import make_train_step

    t_phase = time.perf_counter()
    with open(os.path.join(JPEG_FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    for name, want in sorted(digests["decode"].items()):
        img = read_jpeg(os.path.join(JPEG_FIXTURES, name))
        got = {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
        print(f"jpeg fixture {name}: {got['shape']} sha256 {got['sha256'][:16]}..., "
              f"tcs_tpu's decode's: {got == want}")
        if got != want:
            fail(f"read_jpeg of the fixture {name} gives {got}, tcs_tpu's decode {want}")
    for name, want in sorted(digests["encode"].items()):
        img = read_image(os.path.join(JPEG_FIXTURES, name))
        got = hashlib.sha256(encode_jpeg(img, want["quality"])).hexdigest()
        print(f"jpeg fixture {name}: encode_jpeg at quality {want['quality']} sha256 "
              f"{got[:16]}..., PIL's bytes: {got == want['sha256']}")
        if got != want["sha256"]:
            fail(f"encode_jpeg of the fixture {name} gives sha256 {got}, PIL's bytes "
                 f"{want['sha256']}")

    os.makedirs("runs", exist_ok=True)
    tmp_dir = tempfile.TemporaryDirectory(prefix="falling_things_", dir="runs")
    root = tmp_dir.name
    t0 = time.perf_counter()
    fabricate.falling_things_tree(root, scenes=FT_SCENES, frames=FT_FRAMES, height=FT_H,
                                  width=FT_W)
    files = sorted(glob.glob(os.path.join(root, "FallingThings", "**", "*.jpg"), recursive=True))
    print(f"FallingThings tree ({len(FT_SCENES)} scenes x {FT_FRAMES} pairs, {FT_W}x{FT_H}, "
          f"{len(files)} JPEGs of quality 95) written in {time.perf_counter() - t0:.2f} s")
    dec, enc = [], []
    for path in files:
        for _ in range(3):
            t0 = time.perf_counter()
            img = read_jpeg(path)
            dec.append(1e3 * (time.perf_counter() - t0))
        if img.shape != (FT_H, FT_W, 3):
            fail(f"{path} decodes to {img.shape}")
        t0 = time.perf_counter()
        encode_jpeg(img, 95)
        enc.append(1e3 * (time.perf_counter() - t0))
    print(f"read_jpeg {FT_W}x{FT_H} 4:2:0 q95: median {float(np.median(dec)):.3f} ms a frame "
          f"(min {min(dec):.3f}); encode_jpeg median {float(np.median(enc)):.3f} ms a frame; "
          f"on the host of {smi}")
    cfg = dataclasses.replace(sceneflow_recipe(), train_dataset="falling_things",
                              temporal=False, frame_length=1, data_root=root)
    ds = datasets.fetch_dataset(cfg)
    t0 = time.perf_counter()
    with SequenceLoader(ds, cfg.batch_size, seed=cfg.seed, num_workers=2) as loader:
        batch = next(iter(loader))
    shapes = {k: v.shape for k, v in batch.items()}
    print(f"fetch_dataset('falling_things'): {len(ds)} samples; the loader's first batch in "
          f"{time.perf_counter() - t0:.2f} s: {shapes}")
    h, w = cfg.image_size
    if (len(ds) != 5 * len(files) // 2 or batch["image1"].shape != (cfg.batch_size, 1, h, w, 3)
            or not all(np.isfinite(v).all() for v in batch.values())):
        fail(f"FallingThings through fetch_dataset and the loader: {len(ds)} samples, {shapes}")
    tmp_dir.cleanup()

    total = {}
    cfg_main = ModelConfig()
    model = TCStereo(cfg_main, seed=0)
    ev = TemporalEvaluator(model, cfg_main, iters=MAIN_ITERS)
    rng = np.random.default_rng(2)
    left = rng.uniform(0, 255, (TRACE_FRAMES + 1, MAIN_H, MAIN_W + 64, 3)).astype(np.float32)
    K = np.array([[721.5, 0, MAIN_W / 2], [0, 721.5, MAIN_H / 2], [0, 0, 1]], np.float32)

    def frame(k):
        ev(left[k, :, 32:32 + MAIN_W], left[k, :, 40 + k:40 + k + MAIN_W], K, 0.54, _pose(k))

    frame(0)
    _, counts = traced("main path", os.path.join("runs", "trace_main_path"), model,
                       lambda: [frame(k) for k in range(1, TRACE_FRAMES + 1)], TRACE_FRAMES,
                       "frame")
    total = {k: total.get(k, 0) + v for k, v in counts.items()}

    tcfg = sceneflow_recipe()
    tmodel = TCStereo(tcfg.model, seed=0)
    step = make_train_step(tmodel, tcfg)
    batch = _synthetic_batch(TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_FRAMES, tcfg.seed, "cuda")
    step(batch)
    _, counts = traced("training step", os.path.join("runs", "trace_train_step"), tmodel,
                       lambda: [step(batch) for _ in range(TRACE_STEPS)], TRACE_STEPS, "step")
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    print(f"jpeg and trace: phase 12 took {time.perf_counter() - t_phase:.1f} s, "
          f"launches {total}")
    return total


# Phase 13: tcs_tpu's Orbax checkpoints. (b) trains the fp32 config at the
# SceneFlow recipe's shapes from tcs_tpu's trained weights; each step takes
# its own synthetic batch (seed ORBAX_SEED + step).
ORBAX_FIXTURES = os.path.join("tests", "fixtures", "orbax")
ORBAX_STEPS, ORBAX_SEED = 3, 100
RESUME_RTOL = 1e-6  # of a loss, where the step is not deterministic on the card


def nondeterministic_ops(step, batch) -> list:
    """The library calls of one training step that torch reports as having
    no deterministic implementation on the card (its warnings under
    ``use_deterministic_algorithms(True, warn_only=True)``)."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0][:160] for w in caught
                   if "determinis" in str(w.message)})


def orbax_fixtures(smi: str) -> None:
    """(a) The committed fixtures, decoded by the port to tcs_tpu's digests."""
    import hashlib

    from tcs_tpu_torch.utils import orbax_format, zstd

    with open(os.path.join(ORBAX_FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    t0 = time.perf_counter()
    for name, want in sorted(digests["zstd"].items()):
        with open(os.path.join(ORBAX_FIXTURES, "zstd", name), "rb") as f:
            got = hashlib.sha256(zstd.decompress(f.read(), want["size"])).hexdigest()
        if got != want["sha256"]:
            fail(f"orbax (a): the zstd fixture {name} decodes to sha256 {got}, not "
                 f"{want['sha256']}")
    steps = orbax_format.step_dirs(os.path.join(ORBAX_FIXTURES, "manager"))
    if sorted(steps) != [37]:
        fail(f"orbax (a): committed steps {sorted(steps)}; the uncommitted one must be skipped")
    for tag, path in (("manager", steps[37]), ("export", os.path.join(ORBAX_FIXTURES, "export"))):
        got = orbax_format.tree_digests(orbax_format.read_tree(path))
        bad = sorted(k for k in set(got) | set(digests[tag]) if got.get(k) != digests[tag].get(k))
        if bad:
            fail(f"orbax (a): {tag} leaves differ from tcs_tpu's restore: {bad}")
    print(f"orbax (a): {len(digests['zstd'])} zstd frames, {len(digests['manager'])} leaves of "
          f"the CheckpointManager step and {len(digests['export'])} of the save_params export "
          f"equal tcs_tpu's digests bit for bit, in {time.perf_counter() - t0:.3f} s on the "
          f"host of {smi}")


def _train_state(model, step_fn) -> list:
    opt, sched = step_fn.optimizer, step_fn.scheduler
    out = [t.detach().clone() for t in model.state_dict().values()]
    for p in model.parameters():
        st = opt.state[p]
        out += [st["exp_avg"].clone(), st["exp_avg_sq"].clone(), st["step"].clone()]
    return out + [torch.tensor([sched.last_epoch, opt.param_groups[0]["lr"]], dtype=torch.float64)]


def phase_orbax(smi: str, eval_tree: dict = None) -> dict:
    """Phase 13; returns the kernels' launches of the resumed steps."""
    import tempfile

    from tcs_tpu_torch import ModelConfig
    from tcs_tpu_torch import device as device_lib
    from tcs_tpu_torch import evaluate as ev
    from tcs_tpu_torch.config import sceneflow_recipe
    from tcs_tpu_torch.data import fabricate
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.ops import _kernels
    from tcs_tpu_torch.train import make_train_step
    from tcs_tpu_torch.utils import checkpoint as ck

    t_phase = time.perf_counter()
    orbax_fixtures(smi)
    os.makedirs("runs", exist_ok=True)
    tmp_dir = tempfile.TemporaryDirectory(prefix="orbax_", dir="runs")
    cfg = sceneflow_recipe()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, mixed_precision=False, corr_dtype="float32"))
    batches = [_synthetic_batch(TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_FRAMES, ORBAX_SEED + k, "cuda")
               for k in range(2 * ORBAX_STEPS)]
    export = os.path.join(tmp_dir.name, "export")
    eval_root = eval_tree["root"] if eval_tree else os.path.join(tmp_dir.name, "eval")
    if not eval_tree:  # phase 13 alone: phase 8's TartanAir tree
        fab, kw, _, _ = EVAL_TREES["TartanAir"]
        getattr(fabricate, fab)(eval_root, seed=0, **dict(kw, sequences=(
            ("gascola", "Easy", "P001"), ("hospital", "Hard", "P042"))))

    def trained(seed):
        model = TCStereo(cfg.model, seed=seed)
        ck.load_params_npz(model, FIXTURE)
        return model, make_train_step(model, cfg)

    def run(step_fn, ks):
        return [step_fn(batches[k])["live_loss"].item() for k in ks]

    procs = []  # the CLI of (c): stopped here whatever happens
    try:
        with tf32_off(), device_lib.deterministic():
            # the uninterrupted run writes its state after step 3 and goes on; a
            # fresh model, AdamW and schedule read that state and take the same
            # steps 4-6
            t0 = time.perf_counter()
            model, step_fn = trained(0)
            whole = run(step_fn, range(ORBAX_STEPS))
            state = _train_state(model, step_fn)
            run_dir = os.path.join(tmp_dir.name, "sceneflow")
            nbytes = sum(t.numel() * t.element_size() for t in model.parameters()) * 3
            torch.cuda.synchronize()
            t_steps = time.perf_counter() - t0
            t0 = time.perf_counter()
            ck.save_tcs_tpu(run_dir, ORBAX_STEPS, model, step_fn.optimizer, step_fn.scheduler)
            t_write = time.perf_counter() - t0
            # (c)'s CLI evaluates step 3's export in its own process while this
            # one trains on: it shares the card and changes no result here
            ck.save_params(model, export)
            weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            cli_log = open(os.path.join(tmp_dir.name, "cli.log"), "w+")
            t_cli = time.perf_counter()
            cli = subprocess.Popen([sys.executable, "-m", "tcs_tpu_torch.cli.evaluate", "--dataset",
                                    "TartanAir", "--data_root", eval_root, "--restore_ckpt", export,
                                    "--valid_iters", str(EVAL_ITERS)],
                                   stdout=subprocess.PIPE, stderr=cli_log, text=True)
            procs.append(cli)
            whole += run(step_fn, range(ORBAX_STEPS, 2 * ORBAX_STEPS))
            del model, step_fn
            fresh = TCStereo(cfg.model, seed=2)
            fresh_fn = make_train_step(fresh, cfg)
            t0 = time.perf_counter()
            got_step = ck.restore_tcs_tpu(run_dir, fresh, fresh_fn.optimizer, fresh_fn.scheduler)
            torch.cuda.synchronize()
            t_read = time.perf_counter() - t0
            back = _train_state(fresh, fresh_fn)
            same = len(back) == len(state) and all(torch.equal(a, b) for a, b in zip(back, state))
            del back, state
            print(f"orbax (b): {ORBAX_STEPS} steps from tcs_tpu's trained weights in "
                  f"{t_steps:.2f} s (model, first step included); save_tcs_tpu of step "
                  f"{ORBAX_STEPS} ({nbytes / 1e6:.1f} MB of params and moments) {t_write:.3f} s, "
                  f"{nbytes / 1e6 / t_write:.1f} MB/s written; restore_tcs_tpu into a fresh "
                  f"model {t_read:.3f} s, {nbytes / 1e6 / t_read:.1f} MB/s read (to the card); "
                  f"on {smi}")
            print(f"orbax (b): the restored state equals the written one bit for bit (every "
                  f"parameter, both moments, the step, the learning rate): {same}; step {got_step}")
            if not same or got_step != ORBAX_STEPS:
                fail("orbax (b): the state read back differs from the state written")
            _kernels.reset_launches()
            resumed = run(fresh_fn, range(ORBAX_STEPS, 2 * ORBAX_STEPS))
            torch.cuda.synchronize()
            counts = dict(_kernels.launches)
            exact = resumed == whole[ORBAX_STEPS:]
            racy = [] if exact else nondeterministic_ops(fresh_fn, batches[0])
        want = {"corr_lookup": ORBAX_STEPS * TRAIN_FRAMES * TRAIN_ITERS,
                "corr_lookup_bwd": ORBAX_STEPS * TRAIN_FRAMES * TRAIN_ITERS,
                "splat_sum": ORBAX_STEPS * (TRAIN_FRAMES - 1), "splat_sum_bwd": 0}
        print(f"orbax (b): losses uninterrupted {whole}, resumed {resumed}: equal bit for bit "
              f"{exact}; resumed steps' launches {counts} expected {want}")
        if counts != want:
            fail(f"orbax (b): resumed launch counts {counts} != {want}")
        if not exact:  # the step is not deterministic on the card: name what is not
            rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole[ORBAX_STEPS:]))
            print(f"orbax (b): library calls torch reports as nondeterministic in a step: "
                  f"{racy or 'none'}; resumed losses against uninterrupted, max relative "
                  f"{rel:.3e} (bound {RESUME_RTOL})")
            if not rel <= RESUME_RTOL:
                fail(f"orbax (b): resumed losses {resumed} against {whole[ORBAX_STEPS:]}")
        print(f"orbax (b) took {time.perf_counter() - t_phase:.1f} s with (a)")

        t_c = time.perf_counter()
        direct = TCStereo(ModelConfig(), seed=5)
        direct.load_state_dict(weights)
        want_res = ev.validate_tartanair(direct, ModelConfig(), iters=EVAL_ITERS, root=eval_root)
        out, _ = cli.communicate(timeout=600)
        cli_log.seek(0)
        if cli.returncode != 0:
            fail(f"orbax (c): the evaluation CLI exited {cli.returncode}:\n"
                 f"{cli_log.read()[-4000:]}")
        cli_log.close()
        got_res = json.loads(out.strip().splitlines()[-1])
        print(f"orbax (c): evaluation CLI --restore_ckpt <step {ORBAX_STEPS}'s save_params "
              f"export>, started beside (b)'s last steps, done {time.perf_counter() - t_cli:.2f} "
              f"s after its start: {json.dumps(got_res)}; the weights loaded directly: "
              f"{json.dumps(want_res)}; equal: {got_res == want_res}")
        if got_res != want_res:
            fail("orbax (c): the CLI on the export gives other metrics than the weights directly")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp_dir.cleanup()
    print(f"orbax: phase 13 took {time.perf_counter() - t_phase:.1f} s ((c) after (b) "
          f"{time.perf_counter() - t_c:.1f} s)")
    return counts


MFU_MAX = 1.05  # a share of the peak above this is a fault of the count or of the timed window


def phase_measurement_tools(smi: str) -> dict:
    """Phase 14; returns the launch counts of the phase."""
    from tcs_tpu_torch import ModelConfig, TrainConfig
    from tcs_tpu_torch.ops import _kernels
    from tcs_tpu_torch.utils import flops

    t_phase = time.perf_counter()
    small = ModelConfig(mixed_precision=False, corr_dtype="float32")
    step_cfg = TrainConfig(model=small, train_iters=SMALL_ITERS, batch_size=1,
                           image_size=(SMALL_H, SMALL_W), frame_length=2)
    counts = {}
    for dev in ("cuda", "cpu"):
        with tf32_off():
            frame = flops.inference_flops(small, SMALL_H, SMALL_W, SMALL_ITERS, device=dev)
            step, _ = flops.train_step_flops(step_cfg, device=dev)
        counts[dev] = dict(frame=frame.total, step=step.total, frame_ops=frame.by_op(),
                           step_ops=step.by_op())
        print(f"model FLOPs, fp32 config at {SMALL_H}x{SMALL_W}, on {dev}: one carried frame at "
              f"{SMALL_ITERS} iterations {frame.total}, one 2-frame step {step.total} "
              f"(forward {step.phase('forward')}, backward {step.phase('backward')})")
    if counts["cuda"] != counts["cpu"]:
        fail(f"the card's FLOP count differs from the CPU's: {counts}")
    mfu = _load_script("torch_mfu")
    _kernels.reset_launches()
    # Shorter runs than the script's defaults: this phase keeps to about a minute.
    for rec in (mfu.inference(smi, frames=8), mfu.train(smi, "sceneflow", steps=2)):
        print(mfu.summary(rec))
        print(f"  by op: { {k: round(v / 1e9, 3) for k, v in rec['by_op'].items()} } GFLOP; "
              f"ms each {[round(t, 2) for t in rec['ms_each']]}")
        for key in ("share_of_bf16_peak", "share_of_bf16_peak_in_device_time"):
            if not 0 < rec[key] <= MFU_MAX:
                fail(f"{rec['mode']}: {key} {rec[key]} is outside (0, {MFU_MAX}]")
    torch.cuda.synchronize()
    launched = dict(_kernels.launches)
    print(f"measurement tools: launches {launched}; phase 14 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launched


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = phase_device()
    if sys.argv[1:] == ["--loader-cores"]:
        loader_cores_probe(smi)
        return
    from tcs_tpu_torch.utils.flops import hbm_bytes_per_s

    rate = hbm_bytes_per_s(smi)
    launch_floor()
    rec = phase_kernels(rate)
    phase_small_parity()
    paths = {"inference": phase_main_path(smi), "op_gradients": phase_op_gradients()}
    phase_small_gradient_parity()
    paths["training"], train_ms = phase_training_path(smi)
    paths["evaluation"], eval_tree = phase_evaluators(smi)
    paths["training_from_files"], train_tree = phase_training_from_files(smi, train_ms)
    paths["data_parallel"] = phase_data_parallel(smi, train_ms, eval_tree, train_tree)
    paths["trained_weights"] = phase_trained_weights(smi)
    paths["jpeg_and_trace"] = phase_jpeg_and_trace(smi)
    paths["orbax_resume"] = phase_orbax(smi, eval_tree)
    eval_tree["tmp_dir"].cleanup()
    paths["measurement_tools"] = phase_measurement_tools(smi)
    # `launches` sums the driven paths, each of which set the counts to 0
    # before it and read them after. The times and the bound are at the
    # shapes of the path that launches the kernel most, in the type it runs
    # there: the inference path's for the forward kernels, the training
    # path's for the backward ones; bf16 pyramids, fp32 splat payloads. The
    # forward kernels' numbers at the training path's and the evaluators'
    # shapes, and the path kernels' at the fl4 recipes' shapes, stand beside
    # them; `max_abs_err` is the largest over every shape and type checked.
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
            entry["at_evaluation_shapes"] = {
                sh: {k: rec[name, sh, dtype].get(k) for k in keys}
                for sh in LOOKUP_SHAPES if sh.startswith("evaluation")}
        if name != "splat_sum_bwd":  # which no path launches
            entry["at_fl4_training_shapes"] = {
                sh: {k: rec[name, sh, dtype].get(k) for k in keys}
                for sh in LOOKUP_SHAPES if sh.startswith("training ")}
        if name.startswith("splat"):  # over every shape checked
            for k in ("deterministic", "bit_exact"):
                entry[k] = all(r[k] for r in mine.values())
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
