"""Traffic driver ``stream``: closed-loop streaming inference of a batch of
synchronised stereo streams through ``tcs_tpu_torch.evaluate.TemporalEvaluator``.

The traffic file gives the number of streams, the frames of a scene and the
calls of warm-up and of the traced segment; the configuration's ``stream``
object gives the frame size, the intrinsics, the baseline and the
iterations. Every stream plays its own scene from a pool made from the seed
(uint8 frames, as a decoder hands them over), all cycled; the state is reset
at each scene's first frame. The next call goes when the previous call's
disparities are in host memory.

Correctness: from the seed one pass over the scenes inside the window and
one carried frame k of it are drawn. Frame 0 of that pass is compared with
the reference streaming from scratch. The recurrent state amplifies rounding
from frame to frame, so frame k is compared with the reference taking one
step from the program's own state before k, and the state the program
leaves after k with the state the reference leaves after that step.
"""

from __future__ import annotations

import math
import time
import traceback

import numpy as np

from benchmark.flops import count
from benchmark.lib import bounds, harness, port, scenes, trace, weights
from benchmark.lib.harness import Context
from benchmark.reference import precision
from benchmark.reference.model import Arch, State, TCStereo as RefNet
from benchmark.reference.stream import Stream


def port_program(ctx: Context, state_dict):
    """The system under test: the port's evaluator on the seeded weights."""
    return port.evaluator(ctx.config, state_dict, ctx.device)


def geometry(ctx: Context):
    st, tr = ctx.config["stream"], ctx.traffic
    H, W = st["image_size"]
    return tr["streams"], tr["frames_per_scene"], H, W


def padded(n: int, divis: int) -> int:
    return -(-n // divis) * divis


def make_inputs(ctx: Context) -> dict:
    """The pool: frames (F, D, H, W, 3) uint8 for each view, K (D,3,3),
    baseline (D,), poses (F, D, 4, 4)."""
    D, F, H, W = geometry(ctx)
    st = ctx.config["stream"]
    cl = scenes.clips(D, F, H, W, st["K"], st["baseline"], ctx.seed)

    def frames(key):
        x = np.stack([np.stack([c[key][k] for c in cl]) for k in range(F)])
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)

    return {"image1": frames("image1"), "image2": frames("image2"),
            "K": np.stack([c["K"] for c in cl]),
            "baseline": np.array([c["baseline"] for c in cl], np.float32),
            "T": np.stack([np.stack([c["T"][k] for c in cl]) for k in range(F)])}


def sample(ctx: Context):
    """(pass, carried frame) drawn from the seed."""
    _, F, _, _ = geometry(ctx)
    rng = np.random.default_rng([int(ctx.seed), 0x5EED])
    return int(rng.integers(0, 2)), int(rng.integers(1, F))


def call(program, inp, k):
    return program(inp["image1"][k], inp["image2"][k], inp["K"], inp["baseline"], inp["T"][k])


def drive(ctx: Context, program, inp: dict, seconds: float) -> dict:
    """Warm up, then the window: calls until ``seconds`` have passed and the
    sampled frames are produced. Returns the window's record with the kept
    outputs and states."""
    D, F, _, _ = geometry(ctx)
    p_star, k_star = sample(ctx)
    for k in range(ctx.traffic["warmup_calls"]):
        if k % F == 0:
            program.reset()
        call(program, inp, k % F)
    before = port.launches()
    latencies, kept, failed, first_error = [], {}, 0, None
    calls = bootstraps = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    p, done = 0, False
    while not done:
        for k in range(F):
            if k == 0:
                program.reset()
            sampled = p == p_star and k in (0, k_star)
            if p == p_star and k == k_star:
                kept["state_in"] = program.state
            t = time.perf_counter()
            try:
                out = call(program, inp, k)
                latencies.append(time.perf_counter() - t)
                ok = out.shape == (D,) + inp["image1"].shape[2:4] and bool(np.isfinite(out.sum()))
            except Exception:  # noqa: BLE001 - a failed call is counted, the run goes on
                latencies.append(time.perf_counter() - t)
                first_error = first_error or traceback.format_exc()
                out, ok = None, False
            calls += 1
            bootstraps += k == 0
            failed += not ok
            if sampled:
                kept[k] = out
            if p == p_star and k == k_star:
                kept["state_out"] = program.state
            if time.perf_counter() >= deadline and (p > p_star or (p == p_star and k >= k_star)):
                done = True
                break
        p += 1
    window_s = time.perf_counter() - t_start
    if first_error:
        ctx.log(f"first failed call:\n{first_error}")
    launches = {n: v - before[n] for n, v in port.launches().items()}
    return {"kind": "stream", "setup_s": t_start - ctx.t0, "window_s": window_s,
            "launches": launches,
            "calls": calls, "bootstraps": bootstraps, "frames": calls * D,
            "attempted": calls, "failed": failed, "latencies_s": latencies,
            "kept": kept, "sample": (p_star, k_star)}


def _ref_state(s):
    if s is None:
        return None
    return State(s.disp_q, tuple(s.net_list), s.fmap1, s.T_prev, bool(s.valid))


def _rel_l2(a, r) -> float:
    """‖a − r‖₂ / ‖r‖₂ over the whole batch."""
    a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
    return float(np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30))


def _state_gaps(prog, ref) -> dict:
    """Relative L2 gaps (over the batch) of the state's tensors: disparity,
    matching features, hidden states (the worst of the three); a missing or
    reset state reads as zeros."""
    out = {}
    for key, names in (("state_disp", [("disp_q", None)]), ("state_fmap", [("fmap1", None)]),
                       ("state_net", [("net_list", i) for i in range(3)])):
        worst = 0.0
        for name, i in names:
            r = getattr(ref, name) if i is None else ref.net_list[i]
            if prog is None or not prog.valid:
                a = r * 0
            else:
                a = getattr(prog, name) if i is None else prog.net_list[i]
            worst = max(worst, _rel_l2(a.double().cpu().numpy(), r.double().cpu().numpy()))
        out[key] = worst
    return out


def check(ctx: Context, inp: dict, kept: dict, sample_pk) -> dict:
    """The readings of the sampled frames against the fp32 reference, each a
    relative L2 gap over the batch: ``boot_l2`` frame 0's disparities (the
    reference streaming from scratch); ``state_fmap`` and ``state_net`` the
    matching features and hidden states the program left after the carried
    frame k, against the reference's one step from the program's state
    before k. ``carried_l2`` and ``state_disp`` (frame k's disparities, at
    full and at 1/4 resolution) are logged, not judged: random weights drive
    some seeds' disparities to near zero, where a relative gap reads noise."""
    import torch

    _, k_star = sample_pk
    arch = Arch.from_config(ctx.config["model"])
    out = dict.fromkeys(("boot_l2", "carried_l2", "state_disp", "state_fmap", "state_net"),
                        math.inf)
    with precision.fp32_matmuls():
        ref = RefNet(arch).to(ctx.device)
        ref.load_state_dict(weights.make(arch, ctx.seed, ctx.device))
        rs = Stream(ref, ctx.config["stream"]["iters"], ctx.device)
        r0 = call(rs, inp, 0).cpu().numpy()
        if kept.get(0) is not None:
            out["boot_l2"] = _rel_l2(kept[0], r0)
        rs.state = _ref_state(kept["state_in"])
        try:
            rk = call(rs, inp, k_star).cpu().numpy()
            if kept.get(k_star) is not None:
                out["carried_l2"] = _rel_l2(kept[k_star], rk)
                out.update(_state_gaps(kept["state_out"], rs.state))
        except RuntimeError as e:  # a state of the wrong shape: no reading, not correct
            ctx.log(f"the reference cannot step from the program's state: {e}")
        del ref, rs
    harness.release(torch, ctx.device)
    return out


def flops(ctx: Context):
    """(bootstrap call, carried call) FLOPs at the padded size."""
    D, _, H, W = geometry(ctx)
    d = ctx.config["stream"]["divis_by"]
    return count.stream_call(Arch.from_config(ctx.config["model"]), D, padded(H, d),
                             padded(W, d), ctx.config["stream"]["iters"])


def hand_bytes(ctx: Context, launches: dict) -> float:
    """Bytes the hand kernels must move for the launches made: each input
    byte read once, each output byte written once."""
    D, _, H, W = geometry(ctx)
    d = ctx.config["stream"]["divis_by"]
    f = 2 ** ctx.config["model"]["n_downsample"]
    return bounds.total(launches, D, padded(H, d) // f, padded(W, d) // f, ctx.config["model"])


def run(ctx: Context) -> dict:
    """Set-up, warm-up, the window, the traced segment (``--trace 1``), the
    check."""
    import torch

    inp = make_inputs(ctx)
    sd = weights.make(Arch.from_config(ctx.config["model"]), ctx.seed, ctx.device)
    program = (ctx.program or port_program)(ctx, sd)
    del sd
    rec = drive(ctx, program, inp, ctx.seconds)
    iters = ctx.config["stream"]["iters"]
    rec["launches_needed"] = {"corr_lookup": iters * rec["calls"], "corr_lookup_bwd": 0,
                              "splat_sum": rec["calls"] - rec["bootstraps"], "splat_sum_bwd": 0}
    rec["memory_peak_bytes"] = harness.peak_bytes(torch, ctx.device)
    boot, carried = flops(ctx)
    rec["window_flops"] = boot.total * rec["bootstraps"] + carried.total * (
        rec["calls"] - rec["bootstraps"])
    if ctx.trace:
        _, F, _, _ = geometry(ctx)
        n = ctx.traffic["trace_calls"]
        device_side, host_side = {}, {}
        for holder in (device_side, host_side):
            before = port.launches()
            with trace.profiled(holder, host=holder is host_side):
                for k in range(n):
                    if k % F == 0:
                        program.reset()
                    with trace.span("stream.call.bootstrap" if k % F == 0
                                    else "stream.call.carried"):
                        call(program, inp, k % F)
            launches = {m: v - before[m] for m, v in port.launches().items()}
        nboot = sum(1 for k in range(n) if k % F == 0)
        rec["traced"] = {"calls": n, "summary": device_side["summary"],
                         "host_summary": host_side["summary"],
                         "trace_bytes": device_side["trace_bytes"] + host_side["trace_bytes"],
                         "dense_flops": boot.dense * nboot + carried.dense * (n - nboot),
                         "hand_bytes": hand_bytes(ctx, launches), "launches": launches}
    del program
    harness.release(torch, ctx.device)
    t = time.perf_counter()
    rec["readings"] = check(ctx, inp, rec.pop("kept"), rec["sample"])
    rec["check_s"] = time.perf_counter() - t
    return rec
