"""Traffic driver ``train_step``: ``tcs_tpu_torch``'s training step
(``train.make_train_step``) issued back to back on a pool of batches held on
the card, the host reading each step's loss and gradient norm as the
trainer does.

The configuration's ``train`` object gives the recipe (batch, crop, frames,
iterations, optimiser); the traffic file the pool's size, how its clips are
made and the steps of the traced segment. The pool's batches are distinct
clips made from the seed; the steps cycle over them.

Correctness: set-up builds the step once and drives it through its first
``reference_steps`` steps, on the pool's first batches, through the call the
window uses; the window goes on with the same object. After the window the
reference follows those steps from the same seeded weights on the same
batches, and the readings are each step's loss, each leaf's norm of the
first (clipped) gradient, read from AdamW's first moment after one step, and
each leaf's norm of the change over the steps.
"""

from __future__ import annotations

import math
import time
import traceback
from typing import Dict, List

import numpy as np

from benchmark.flops import count
from benchmark.lib import bounds, harness, port, scenes, trace, weights
from benchmark.lib.harness import Context
from benchmark.reference import precision
from benchmark.reference.model import Arch, TCStereo as RefNet
from benchmark.reference.train import Step

BATCH_KEYS = ("image1", "image2", "flow", "valid", "T", "K", "baseline")


def recipe(ctx: Context) -> dict:
    return dict(ctx.config["train"], init_thres=ctx.config["model"]["init_thres"])


def port_program(ctx: Context, state_dict):
    return port.TrainStep(ctx.config, state_dict, ctx.device)


def make_pool(ctx: Context) -> List[dict]:
    """``pool_batches`` batches of distinct clips, as tensors on the device."""
    import torch

    r, tr = ctx.config["train"], ctx.traffic
    B, F = r["batch_size"], r["frame_length"]
    H, W = r["image_size"]
    cl = scenes.clips(B * tr["pool_batches"], F, H, W,
                      scenes.principal_k(tr["fx_over_width"] * W, H, W), tr["baseline"], ctx.seed)
    pool = []
    for j in range(tr["pool_batches"]):
        rows = cl[j * B:(j + 1) * B]
        pool.append({k: torch.as_tensor(np.stack([np.asarray(c[k], np.float32) for c in rows]),
                                        device=ctx.device) for k in BATCH_KEYS})
    return pool


def _leaf_norms(pairs) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in pairs}


class Seams:
    """The step's ``mark`` seams as benchmark spans: each frame's forward and
    losses, its backward, then the update."""

    def __init__(self, frames: int):
        self.frames, self.t, self.open = frames, 0, None

    def _enter(self, name):
        self.open = trace.span(name)
        self.open.__enter__()

    def _exit(self):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None

    def begin(self):
        self.t = 0
        self._enter("train.forward.bootstrap")

    def __call__(self, seam: str):
        self._exit()
        if seam == "forward":
            self._enter("train.backward.bootstrap" if self.t == 0 else "train.backward.carried")
        elif seam == "backward":
            self.t += 1
            self._enter("train.forward.carried" if self.t < self.frames else "train.update")

    def end(self):
        self._exit()


def first_steps(program, batches, p0) -> dict:
    """The program's first steps, through the window's call, on distinct
    batches: each step's loss, the first clipped gradient's leaf norms, the
    change's leaf norms from the weights ``p0``."""
    prog = {"loss": [], "grad_norm": []}
    for s, b in enumerate(batches):
        loss, gnorm = program(b)
        prog["loss"].append(float(loss))
        prog["grad_norm"].append(float(gnorm))
        if s == 0:
            prog["grad_vec"] = program.first_grads()
            prog["grad"] = _leaf_norms(prog["grad_vec"].items())
    prog["change"] = _leaf_norms((n, p.detach() - p0[n]) for n, p in program.named_parameters())
    return prog


def run(ctx: Context) -> dict:
    import torch

    arch = Arch.from_config(ctx.config["model"])
    r, tr = ctx.config["train"], ctx.traffic
    pool = make_pool(ctx)
    sd = weights.make(arch, ctx.seed, ctx.device)
    program = (ctx.program or port_program)(ctx, sd)
    batches = [port.batch(b) for b in pool] if ctx.program is None else pool

    n_ref = tr["reference_steps"]
    prog = first_steps(program, batches[:n_ref], sd)
    del sd

    steps = failed = 0
    first_error = None
    before = port.launches()
    setup_peak = harness.peak_bytes(torch, ctx.device)
    harness.reset_peak(torch, ctx.device)
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    while time.perf_counter() < deadline:
        try:
            loss, gnorm = program(batches[(n_ref + steps) % len(batches)])
            ok = math.isfinite(float(loss)) and math.isfinite(float(gnorm))
        except Exception:  # noqa: BLE001 - a failed step is counted, the run goes on
            first_error = first_error or traceback.format_exc()
            ok = False
        steps += 1
        failed += not ok
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    window_s = time.perf_counter() - t_start
    if first_error:
        ctx.log(f"first failed step:\n{first_error}")
    F, B = r["frame_length"], r["batch_size"]
    rec = {"kind": "train", "setup_s": t_start - ctx.t0, "window_s": window_s, "steps": steps,
           "frames": steps * B * F, "attempted": steps, "failed": failed,
           "window_peak_bytes": harness.peak_bytes(torch, ctx.device),
           "launches": {n: v - before[n] for n, v in port.launches().items()}}
    iters = r["train_iters"]
    rec["launches_needed"] = {"corr_lookup": iters * F * steps,
                              "corr_lookup_bwd": iters * F * steps,
                              "splat_sum": (F - 1) * steps, "splat_sum_bwd": 0}
    rec["memory_peak_bytes"] = max(setup_peak, rec["window_peak_bytes"])
    H, W = r["image_size"]
    step_flops = count.train_step(arch, recipe(ctx), B, H, W, F)
    rec["window_flops"] = step_flops.total * steps

    if ctx.trace:
        n = tr["trace_steps"]
        device_side, host_side = {}, {}
        for holder in (device_side, host_side):
            seams = Seams(F)
            before = port.launches()
            with trace.profiled(holder, host=holder is host_side):
                for s in range(n):
                    with trace.span("train.step"):
                        seams.begin()
                        loss, gnorm = program(batches[s % len(batches)], seams)
                        seams.end()
                        float(loss), float(gnorm)
            launches = {m: v - before[m] for m, v in port.launches().items()}
        f = 2 ** ctx.config["model"]["n_downsample"]
        rec["traced"] = {"calls": n, "summary": device_side["summary"],
                         "host_summary": host_side["summary"],
                         "trace_bytes": device_side["trace_bytes"] + host_side["trace_bytes"],
                         "dense_flops": step_flops.dense * n, "launches": launches,
                         "hand_bytes": bounds.total(launches, B, -(-H // f), -(-W // f),
                                                    ctx.config["model"])}
    del program, batches
    harness.release(torch, ctx.device)
    t = time.perf_counter()
    rec["readings"] = check(ctx, pool[:n_ref], prog)
    rec["check_s"] = time.perf_counter() - t
    return rec


def follow(ctx: Context, batches, mode: str = "fp32"):
    """The reference (``mode`` fp32) or the control (``mode`` fp8) through the
    steps on ``batches`` from the seeded weights: per-step losses, the first
    clipped gradient's leaf norms, the change's leaf norms."""
    arch = Arch.from_config(ctx.config["model"])
    net = RefNet(arch, mode=mode).to(ctx.device)
    p0 = weights.make(arch, ctx.seed, ctx.device)
    net.load_state_dict(p0)
    step = Step(net, recipe(ctx))
    out = {"loss": [], "grad_norm": []}
    with precision.fp32_matmuls():
        for b in batches:
            r = step(b)
            out["loss"].append(float(r["loss"]))
            out["grad_norm"].append(float(r["grad_norm"]))
    names = [n for n, _ in net.named_parameters()]
    out["grad_vec"] = {n: g.double().cpu() for n, g in zip(names, step.first_grads)}
    out["grad"] = _leaf_norms(out["grad_vec"].items())
    out["change"] = _leaf_norms((n, p.detach() - p0[n]) for n, p in net.named_parameters())
    return out


def readings(prog: dict, ref: dict) -> dict:
    """The numbers compared. ``loss_rel``: the worst step's relative loss gap.
    ``grad_leaf`` and ``change_leaf``: the worst leaf's gap between the
    program's and the reference's norms of the first (clipped) gradient and
    of the change over the steps, against the larger of the leaf's and the
    median leaf's reference norm. ``grad_diff_q25_leaf``: each leaf's norm of
    the first gradient's difference over its reference norm, at the lower
    quartile of the leaves: the leaves least moved by the discontinuities
    (the bootstrap's argmax, the top-k of the cost-volume loss) show the
    arithmetic's precision, which the upper leaves' readings drown. Leaves
    whose reference gradient is under a thousandth of the median leaf's (a
    bias under an instance norm, whose gradient is nought but for rounding)
    are left out: rounding alone sets their gradient, and AdamW moves them
    by it. The global norm's gap and the worst leaves' names are logged."""
    loss = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog["loss"], ref["loss"]))
    g = sorted(ref["grad"].values())
    moving = sorted(n for n, v in ref["grad"].items() if v >= 1e-3 * g[len(g) // 2])
    diff = sorted(float((prog["grad_vec"][n] - ref["grad_vec"][n]).norm()
                        / ref["grad_vec"][n].norm().clamp(min=1e-30)) for n in moving)
    return {"loss_rel": loss,
            "grad_leaf": harness.worst_leaf_gap(prog["grad"], ref["grad"], moving),
            "change_leaf": harness.worst_leaf_gap(prog["change"], ref["change"], moving),
            "grad_diff_q25_leaf": diff[len(diff) // 4],
            "grad_norm_rel": max(abs(a - b) / max(b, 1e-30)
                                 for a, b in zip(prog["grad_norm"], ref["grad_norm"])),
            "left_out_leaves": len(ref["grad"]) - len(moving),
            "worst_grad_leaves": harness.worst_leaves(prog["grad"], ref["grad"], moving),
            "worst_change_leaves": harness.worst_leaves(prog["change"], ref["change"], moving)}


def check(ctx: Context, batches, prog: dict) -> dict:
    import torch

    ref = follow(ctx, batches, "fp32")
    harness.release(torch, ctx.device)
    return readings(prog, ref)
