#!/usr/bin/env python
"""Each stage of the port's streaming frame alone, on the card, at the
streaming path's shapes (B1 384×1280, iters 5, the default bf16 config, the
state carried), on device-resident inputs.

The stages' inputs are the tensors one carried frame of the model gives
them (captured from a run of ``TCStereo.forward``), and each stage is timed
alone by its device time: the kernels', copies' and fills' time summed from
a ``torch.profiler`` trace of a few calls (the L2 warm; host work and the
waits between launches are not in it, as some stages wait for the device
inside; the two hand kernels alone with ``chip_smoke.cuda_ms``, back to
back behind a device sleep, as phase 2 times them): the encoder trunk
and context heads (``cnet``), the matching head (``conv2``), the cost
volume, its pyramid, the first frame's ``argmax_disp`` bootstrap, the warp
(geometry and the softmax splat), ``splat_sum`` alone on the warp's
payload, one GRU iteration with its lookup (``TCStereo.iteration``), the
lookup alone, and the mask head with the convex upsample. Beside each:
its model FLOPs (``utils/flops.py``) and TFLOP/s, and for the two hand
kernels their bytes and byte bound (``chip_smoke.py``'s counts). Then the
sum over one carried frame (every stage once but the argmax, which only the
first frame runs, and the lookup, inside the iteration; the iteration
``iters`` times) beside the whole frame's device time, timed the same way,
and its time by CUDA events around each call.

    python scripts/torch_bench_components.py [--size H W] [--iters N]

The last line of standard output is one JSON record with the card's
``nvidia-smi --query-gpu=name,power.limit`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from torch_mfu import events_ms  # noqa: E402

DEV = "cuda"
LOGDIR = os.path.join("runs", "torch_bench_components_trace")
TRACED = 2  # calls of a stage or of the whole frame in its trace
ONE_KERNEL = ("splat_sum alone (258 channels)", "lookup alone")


def captured_frame(model, cfg, H: int, W: int, iters: int):
    """A carried frame's inputs (images, state, camera, pose) and the
    tensors its stages take, from one run of the model."""
    from tcs_tpu_torch.models import TemporalState

    g = torch.Generator().manual_seed(0)
    img1 = (torch.rand(1, H, W, 3, generator=g) * 255).to(DEV)
    img2 = torch.roll(img1, -8, dims=2)
    cam = cs._camera(1, H, W, DEV)
    T0 = torch.eye(4, device=DEV)[None]
    T1 = torch.from_numpy(cs._pose(1))[None].to(DEV)
    state = model(img1, img2, TemporalState.zeros(1, H, W, cfg, device=DEV), cam, T0,
                  iters=iters).new_state
    seen = {}
    iteration = model.iteration

    def capture(*args):
        seen.setdefault("iteration", args)
        return iteration(*args)

    hooks = [model.cnet.register_forward_pre_hook(lambda m, a: seen.setdefault("cnet", a)),
             model.conv2.register_forward_pre_hook(lambda m, a: seen.setdefault("conv2", a)),
             model.disp_refine.mask.register_forward_pre_hook(
                 lambda m, a: seen.setdefault("mask", a))]
    model.iteration = capture
    try:
        model(img1, img2, state, cam, T1, iters=iters)
    finally:
        del model.iteration
        for h in hooks:
            h.remove()
    return (img1, img2, state, cam, T1), seen


def counted(fn) -> int:
    from tcs_tpu_torch.utils.flops import FlopCounter

    with FlopCounter() as counter:
        fn()
    return counter.total


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, nargs=2, default=(cs.MAIN_H, cs.MAIN_W))
    ap.add_argument("--iters", type=int, default=cs.MAIN_ITERS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU: the stages are timed on the card")
    smi = cs.phase_device()
    print(json.dumps(stages(smi, *args.size, args.iters)))


def stages(smi: str, H: int, W: int, iters: int) -> dict:
    """The table and the record; ``chip_smoke.py`` phase 14 calls this."""
    from tcs_tpu_torch import ModelConfig, geometry
    from tcs_tpu_torch.models import TCStereo
    from tcs_tpu_torch.ops import corr, splat
    from tcs_tpu_torch.ops.sampler import convex_upsample_nchw
    from tcs_tpu_torch.ops.sampler import to_nchw as _c
    from tcs_tpu_torch.ops.sampler import to_nhwc as _h
    from tcs_tpu_torch.utils.flops import hbm_bytes_per_s
    from tcs_tpu_torch.utils.profiling import device_ms

    cfg = ModelConfig()
    model = TCStereo(cfg, device=DEV, seed=0)
    rate = hbm_bytes_per_s(smi)
    with torch.no_grad():
        (img1, img2, state, cam, T), seen = captured_frame(model, cfg, H, W, iters)
        f, L, r = cfg.downsample_factor, cfg.corr_levels, cfg.corr_radius
        trunk = model.cnet(*seen["cnet"])[1]
        fmap = _h(model.conv2(trunk)).float()
        fmap1, fmap2 = fmap[:1].contiguous(), fmap[1:]
        raw = corr.build_cost_volume(fmap1, fmap2)
        disp, xs, net_list, inp_list, grad_list, pyramid = seen["iteration"]
        coords = (xs - disp[..., 0]).contiguous()
        K = geometry.scale_intrinsics(cam.K, cfg.scale_rate)
        K_inv = torch.linalg.inv(K)
        rel = geometry.cal_relative_transformation(state.T_prev, T)
        payload = torch.randn(*disp.shape[:3], 258, device=DEV)
        flow = torch.randn(*disp.shape[:3], 2, device=DEV)
        fused = seen["mask"][0]
        corr_dt = getattr(torch, cfg.corr_dtype)
        table = {
            "encoder trunk and context heads (cnet)": lambda: model.cnet(*seen["cnet"]),
            "matching head (conv2)": lambda: model.conv2(*seen["conv2"]),
            "cost volume": lambda: corr.build_cost_volume(fmap1, fmap2),
            "pyramid": lambda: tuple(x.to(corr_dt).contiguous()
                                     for x in corr.corr_pyramid(raw, L)),
            "argmax_disp (first frame only)": lambda: corr.argmax_disp(
                corr.masked_cost_volume(raw), cfg.argmax_margin, cfg.argmax_suppress_radius),
            "warp (geometry and softsplat)": lambda: geometry.warp(
                state.disp_q, state.fmap1, rel, K, K_inv, cam.baseline),
            "splat_sum alone (258 channels)": lambda: splat.splat_sum(payload, flow),
            "GRU iteration with its lookup": lambda: model.iteration(
                disp, xs, net_list, inp_list, grad_list, pyramid),
            "lookup alone": lambda: corr.lookup(pyramid, coords, r),
            "mask head and convex upsample": lambda: convex_upsample_nchw(
                _c(-disp), model.disp_refine.mask(fused), f),
        }
        rows = {}
        for k, (name, fn) in enumerate(table.items()):
            if name in ONE_KERNEL:
                # A trace of these launches alone has held only some of
                # them: timed as phase 2 times them.
                rows[name] = dict(ms=cs.cuda_ms(fn, reps=20), events=1, flops=counted(fn))
                continue
            ms, events = device_ms(fn, os.path.join(LOGDIR, f"stage{k}"), TRACED)
            rows[name] = dict(ms=ms, events=events, flops=counted(fn))
        rows["lookup alone"]["bytes"] = cs._lookup_bytes(pyramid, coords, r)
        rows["splat_sum alone (258 channels)"]["bytes"] = (
            payload.numel() + flow.numel() + payload.numel()) * 4
        frame_fn = lambda: model(img1, img2, state, cam, T, iters=iters)  # noqa: E731
        ms, events = device_ms(frame_fn, os.path.join(LOGDIR, "frame"), TRACED)
        wall = sorted(events_ms(frame_fn) for _ in range(3))  # the median of three
        whole = dict(ms=ms, events=events, wall_ms=wall[1], flops=counted(frame_fn))
    once = [n for n in table if not n.startswith(("argmax", "splat_sum alone", "lookup alone",
                                                  "GRU"))]
    total_ms = (sum(rows[n]["ms"] for n in once)
                + iters * rows["GRU iteration with its lookup"]["ms"])
    print(f"stages of one carried frame, B1 {H}x{W}, iters {iters}, default bf16 config, "
          f"device time (a profiler trace's kernels, copies and fills; L2 warm) on {smi}")
    print(f"{'stage':<44} {'ms':>9} {'events':>7} {'GFLOP':>10} {'TFLOP/s':>8}  bytes / bound")
    for name, row in rows.items():
        extra = ""
        if "bytes" in row:
            row["bound_ms"] = row["bytes"] / rate * 1e3
            extra = f"  {row['bytes']} B, bound {row['bound_ms']:.4f} ms"
        # A stage of a few microseconds can still go unrecorded by the profiler.
        row["tflops_per_s"] = row["flops"] / row["ms"] / 1e9 if row["ms"] else None
        speed = f"{row['tflops_per_s']:8.2f}" if row["ms"] else "  (no device time recorded)"
        print(f"{name:<44} {row['ms']:9.4f} {row['events']:7.0f} {row['flops'] / 1e9:10.3f} "
              f"{speed}{extra}")
    staged = (sum(rows[n]["events"] for n in once)
              + iters * rows["GRU iteration with its lookup"]["events"])
    if whole["events"] < staged:
        # Seen once on the card after thirteen phases in one process.
        print(f"  (the frame's trace holds {whole['events']:.0f} device events a frame, fewer "
              f"than its stages' {staged:.0f}: it lost events, its device time reads short)")
    print(f"sum over one carried frame (each stage once, the iteration x{iters}): "
          f"{total_ms:.3f} ms; the whole frame {whole['ms']:.3f} ms of device time "
          f"({whole['events']:.0f} device events, {whole['wall_ms']:.3f} ms by CUDA events, "
          f"{whole['flops'] / 1e9:.1f} GFLOP); not in a stage: {whole['ms'] - total_ms:.3f} ms "
          f"(context projections, completion, hidden-state back-warp and fusion, glue)")
    return dict(card=smi, shape=f"B1 {H}x{W}", iters=iters, stages=rows,
                stages_sum_ms=total_ms, frame=whole)


if __name__ == "__main__":
    main()
