#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit, torch/CUDA versions, and the
   build of the hand-written kernels from ``tcs_tpu_torch/csrc``;
2. kernel checks: each kernel against its plain PyTorch version on the card,
   at the main path's shapes, with times (CUDA events) and bounds;
3. small-model parity: the fp32 config at 64×96 for 3 frames, on the card
   with the kernels and on the CPU with the plain versions, same weights;
4. main path: ``TemporalEvaluator`` over the default config (bf16 conv
   stacks, bf16 pyramid) at 384×1280, iters 5, 12 frames with a moving pose,
   with the kernels' launch counts read around it.

The last line of standard output is the JSON device record. Run from the
repository root: ``python chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
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


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls.

    The calls are queued behind a device-side sleep that outlasts their host
    work, so the CUDA events time the device, not the Python wrapper. A
    function that synchronises inside (boolean-mask indexing) cannot queue
    ahead, and its time includes its host work.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * reps * host_s + 1e-3) * 2e9))  # cycles at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return smi


def phase_kernels(rate: float) -> dict:
    from tcs_tpu_torch.ops import corr, splat

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    B, h, w, L, r = 1, MAIN_H // 4, MAIN_W // 4, 4, 4
    f1 = torch.randn(B, h, w, 256, generator=g).to(dev)
    f2 = torch.randn(B, h, w, 256, generator=g).to(dev)
    pyr32 = tuple(p.contiguous() for p in corr.corr_pyramid(corr.build_cost_volume(f1, f2), L))
    # Coordinates past both ends of the row exercise the zero padding.
    coords = (torch.rand(B, h, w, generator=g) * (w + 40) - 20).to(dev)
    records = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        pyr = tuple(p.to(dt).contiguous() for p in pyr32)
        out = corr.lookup(pyr, coords, r)
        ref = corr.lookup_plain(pyr, coords, r)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        print(f"lookup[{name}] max|d| = {err:.3e} (tol {LOOKUP_TOL[name]:.0e})")
        if not err <= LOOKUP_TOL[name]:
            fail(f"lookup[{name}] disagrees with lookup_plain: {err}")
        ms = cuda_ms(lambda: corr.lookup(pyr, coords, r))
        plain_ms = cuda_ms(lambda: corr.lookup_plain(pyr, coords, r))
        # Bytes the function must move: the in-range window taps this run's
        # coordinates select, the coordinates, and the fp32 output.
        taps = 0
        for i, p in enumerate(pyr):
            base = torch.floor(coords / 2 ** i)[..., None] + torch.arange(-r, r + 2, device=dev)
            taps += int(((base >= 0) & (base <= p.shape[-1] - 1)).sum())
        nbytes = taps * pyr[0].element_size() + coords.numel() * 4 + out.numel() * 4
        records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=nbytes / rate * 1e3)
        print(f"lookup[{name}] kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {nbytes / rate * 1e3:.4f} ({nbytes} B)")

    # Splat at the warp's payload: (B, h, w, 258) fp32, flow mostly small,
    # some targets out of the image, some non-finite.
    C = 258
    values = torch.randn(B, h, w, C, generator=g).to(dev)
    flow = (torch.randn(B, h, w, 2, generator=g) * 3.0).to(dev)
    flow[:, :, :8, 0] = -30.0
    flow[:, :4, :, 1] = 1e4
    flow[:, 50, 100:140, 0] = float("nan")
    flow[:, 60, 10:20, 1] = float("inf")
    out = splat.splat_sum(values, flow)
    ref = splat.splat_sum_plain(values, flow)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    print(f"splat_sum max|d| = {err:.3e} (tol {SPLAT_RTOL:.0e} x {scale:.3e})")
    if not err <= SPLAT_RTOL * scale:
        fail(f"splat_sum disagrees with splat_sum_plain: {err}")
    ms = cuda_ms(lambda: splat.splat_sum(values, flow))
    plain_ms = cuda_ms(lambda: splat.splat_sum_plain(values, flow), reps=10)
    # Library yardstick: one index_add_ of the four taps' weighted rows.
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    tx, ty = xs + flow[0, ..., 0], ys + flow[0, ..., 1]
    fin = torch.isfinite(tx) & torch.isfinite(ty)
    x0, y0 = torch.floor(tx), torch.floor(ty)
    idx, rows = [], []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        ok = fin & (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        wgt = (1 - (tx - xi).abs()) * (1 - (ty - yi).abs())
        idx.append((yi * w + xi)[ok].long())
        rows.append(values[0][ok] * wgt[ok][:, None])
    idx, rows = torch.cat(idx), torch.cat(rows)
    acc = torch.zeros(h * w, C, device=dev)
    library_ms = cuda_ms(lambda: acc.index_add_(0, idx, rows))
    nbytes = (values.numel() + flow.numel() + out.numel()) * 4
    records["splat"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=nbytes / rate * 1e3, library_ms=library_ms)
    print(f"splat_sum kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms:.4f} bound_ms {nbytes / rate * 1e3:.4f} ({nbytes} B)")
    return records


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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(mixed_precision=False, corr_dtype="float32")
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 255, (SMALL_FRAMES, 2, 1, SMALL_H, SMALL_W, 3)).astype(np.float32)
    flows = {}
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
    torch.backends.cudnn.allow_tf32 = True


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
    want = {"corr_lookup": MAIN_ITERS * MAIN_FRAMES, "splat_sum": MAIN_FRAMES - 1}
    print(f"launches {counts} expected {want}")
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    steady = sorted(times[2:])
    med = steady[len(steady) // 2]
    print(f"main path frame ms: {[round(t, 3) for t in times]}")
    print(f"main path {H}x{W} iters {MAIN_ITERS}: steady-state median "
          f"{med:.3f} ms/frame ({1000 / med:.2f} frames/s) on {smi}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = phase_device()
    rate = hbm_bytes_per_s(smi)
    rec = phase_kernels(rate)
    phase_small_parity()
    counts = phase_main_path(smi)
    lk = rec["bfloat16"]  # the main path's pyramid type
    kernels = [
        dict(name="corr_lookup", route="cuda", source="tcs_tpu_torch/csrc/corr_lookup.cu",
             replaces="tcs_tpu/ops/pallas/corr_kernel.py:76", launches=counts["corr_lookup"],
             max_abs_err=max(rec["float32"]["max_abs_err"], lk["max_abs_err"]),
             ms=lk["ms"], plain_ms=lk["plain_ms"], bound_ms=lk["bound_ms"],
             bound_by="bytes", library_ms=None),
        dict(name="splat_sum", route="cuda", source="tcs_tpu_torch/csrc/softsplat.cu",
             replaces="tcs_tpu/ops/splat.py:30", launches=counts["splat_sum"],
             max_abs_err=rec["splat"]["max_abs_err"], ms=rec["splat"]["ms"],
             plain_ms=rec["splat"]["plain_ms"], bound_ms=rec["splat"]["bound_ms"],
             bound_by="bytes", library_ms=rec["splat"]["library_ms"]),
    ]
    print(f"lookup fp32 pyramid: ms {rec['float32']['ms']:.4f} plain_ms "
          f"{rec['float32']['plain_ms']:.4f} bound_ms {rec['float32']['bound_ms']:.4f}")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
