"""Traffic driver ``train_ddp``: ``tcs_tpu_torch``'s training step under DDP,
one process a card, each rank issuing steps back to back on a pool of
batches held on its card, and reading each step's loss and gradient norm on
the host as the trainer does.

The traffic file gives the ranks, the pool, how clips are made and the
steps of the traced segment; the configuration's ``train`` object gives
one rank's recipe (batch, crop, frames, iterations, optimiser). Global
batch j is ``ranks × batch`` clips made from the seed as ``train_step``
makes its pool; rank r holds rows r·batch … (r+1)·batch − 1 of each.

Rank 0 is the run's process (``run``); ranks 1 … W−1 are spawned
(:mod:`benchmark.lib.ranks`) and run :func:`rank_main`. Every rank builds
the program as the port's trainer does (:mod:`benchmark.lib.port_ddp`),
drives its first ``reference_steps`` steps through the window's call,
then steps until rank 0's clock passes the window's end: rank 0 puts its
verdict into the step's own sum over the ranks, so every rank stops after
the same step. With a trace every rank runs the traced steps and rank 0
profiles them. Every worker has ended before rank 0 checks.

Correctness: rank 0 follows the first steps with the plain reference on
the global batches, in blocks of one rank's rows
(:mod:`benchmark.reference.train_blocks`), from the same seeded weights;
the readings are ``train_step``'s: each step's global loss and gradient
norm, each leaf's norm of the first clipped gradient (rank 0's AdamW
moment) and of the change over the steps.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List

from benchmark.drivers import train_step
from benchmark.flops import count
from benchmark.lib import bounds, harness, port, port_ddp, ranks, trace, weights
from benchmark.lib.control import TrainControl
from benchmark.lib.harness import Context
from benchmark.reference import precision
from benchmark.reference.model import Arch, TCStereo as RefNet
from benchmark.reference.train_blocks import BlockStep


def batch_size(ctx: Context) -> int:
    return ctx.config["train"]["batch_size"]


def global_batch(ctx: Context, j: int, world: int) -> dict:
    """Global batch ``j``: ``world × batch`` clips, as tensors on the device."""
    B = batch_size(ctx)
    train = dict(ctx.config["train"], batch_size=B * world)
    sub = dataclasses.replace(ctx, seed=ctx.seed + j * B * world,
                              config=dict(ctx.config, train=train),
                              traffic=dict(ctx.traffic, pool_batches=1))
    return train_step.make_pool(sub)[0]


def rank_pool(ctx: Context, rank: int, world: int) -> List[dict]:
    """Rank ``rank``'s rows of each global batch of the pool."""
    B = batch_size(ctx)
    return [train_step.make_pool(dataclasses.replace(
        ctx, seed=ctx.seed + (j * world + rank) * B,
        traffic=dict(ctx.traffic, pool_batches=1)))[0]
        for j in range(ctx.traffic["pool_batches"])]


def _spec(ctx: Context, world: int, address: str, fault=None) -> dict:
    """What a spawned rank needs to rebuild the run's context."""
    return {"entry": f"drivers/{ctx.traffic['driver']}.py", "cell": ctx.cell,
            "config": ctx.config, "traffic": ctx.traffic, "seed": ctx.seed, "seconds": ctx.seconds,
            "trace": ctx.trace, "device": ctx.device.type, "world": world,
            "address": address, "fault": fault}


def _build(ctx: Context, sd, fault):
    if fault is None:
        return port_ddp.TrainStep(ctx.config, sd, ctx.device)
    from benchmark.lib import ddp_faults

    return ddp_faults.build(fault, ctx, sd)


def prepare(ctx: Context, rank: int, world: int, fault=None):
    """One rank's program on its pool, through its first steps: (program,
    its batches, the first steps' readings)."""
    arch = Arch.from_config(ctx.config["model"])
    pool = rank_pool(ctx, rank, world)
    if fault is not None:
        from benchmark.lib import ddp_faults

        pool = ddp_faults.pool(fault, ctx, rank, world, pool)
    sd = weights.make(arch, ctx.seed, ctx.device)
    program = _build(ctx, sd, fault)
    batches = [port.batch(b) for b in pool]
    prog = train_step.first_steps(program, batches[:ctx.traffic["reference_steps"]], sd)
    return program, batches, prog


def drive(ctx: Context, rank: int, world: int, address: str, fault=None, beat=lambda: None):
    """One rank's part of a run: build, first steps, window, traced steps.
    Returns (record, the first steps' readings)."""
    import torch

    port_ddp.initialize(address, world, rank, ctx.device)
    arch = Arch.from_config(ctx.config["model"])
    r, tr = ctx.config["train"], ctx.traffic
    n_ref = tr["reference_steps"]
    program, batches, prog = prepare(ctx, rank, world, fault)
    beat()

    steps = failed = 0
    before = port.launches()
    setup_peak = harness.peak_bytes(torch, ctx.device)
    harness.reset_peak(torch, ctx.device)
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    while True:
        program.stop = rank == 0 and time.perf_counter() >= deadline
        loss, gnorm = program(batches[(n_ref + steps) % len(batches)])
        steps += 1
        failed += not (math.isfinite(float(loss)) and math.isfinite(float(gnorm)))
        beat()
        if program.stopped:
            break
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    window_s = time.perf_counter() - t_start
    F, B = r["frame_length"], r["batch_size"]
    rec = {"kind": "train", "setup_s": t_start - ctx.t0, "window_s": window_s,
           "steps": steps, "frames": steps * world * B * F, "attempted": steps,
           "failed": failed, "window_peak_bytes": harness.peak_bytes(torch, ctx.device),
           "launches": {n: v - before[n] for n, v in port.launches().items()}}
    iters = r["train_iters"]
    rec["launches_needed"] = {"corr_lookup": iters * F * steps,
                              "corr_lookup_bwd": iters * F * steps,
                              "splat_sum": (F - 1) * steps, "splat_sum_bwd": 0}
    rec["memory_peak_bytes"] = max(setup_peak, rec["window_peak_bytes"])
    H, W = r["image_size"]
    step_flops = count.train_step(arch, train_step.recipe(ctx), B, H, W, F)
    rec["window_flops"] = step_flops.total * steps

    program.stop = False
    if ctx.trace:
        n = tr["trace_steps"]
        if rank == 0:
            rec["traced"] = _traced(ctx, program, batches, n, step_flops)
        else:
            for s in list(range(n)) * 2:
                program(batches[s % len(batches)])
    del program, batches
    # Left only on success: after a failure the peers may never join.
    port_ddp.destroy()
    return rec, prog


def _traced(ctx: Context, program, batches, n: int, step_flops) -> dict:
    """Rank 0's traced steps: once with the card's activity alone, once with
    the host's operators; the other ranks step alongside."""
    r = ctx.config["train"]
    F, B = r["frame_length"], r["batch_size"]
    H, W = r["image_size"]
    device_side, host_side = {}, {}
    for holder in (device_side, host_side):
        seams = train_step.Seams(F)
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
    return {"calls": n, "summary": device_side["summary"], "host_summary": host_side["summary"],
            "trace_bytes": device_side["trace_bytes"] + host_side["trace_bytes"],
            "dense_flops": step_flops.dense * n, "launches": launches,
            "hand_bytes": bounds.total(launches, B, -(-H // f), -(-W // f),
                                       ctx.config["model"])}


def rank_main(spec: dict, rank: int) -> dict:
    """A spawned rank (:func:`benchmark.lib.ranks.worker_main`): its record,
    with its memory peaks, for rank 0."""
    import torch

    torch.set_num_threads(spec.get("threads", torch.get_num_threads()))
    dev = torch.device("cuda", rank) if spec["device"] == "cuda" else torch.device("cpu")
    ctx = Context(cell=spec["cell"], config=spec["config"], traffic=spec["traffic"], limits={},
                  seed=spec["seed"], seconds=spec["seconds"], trace=spec["trace"], device=dev,
                  t0=time.perf_counter())
    rec, _ = drive(ctx, rank, spec["world"], spec["address"], spec["fault"])
    return {k: rec[k] for k in ("steps", "failed", "memory_peak_bytes", "window_peak_bytes")}


class BlockControl(TrainControl):
    """The control for a data-parallel cell: the reference in fp8 on the
    global batch, in blocks of one rank's rows, in the program's place."""

    def __init__(self, ctx, state_dict, mode: str = "fp8"):
        super().__init__(ctx, state_dict, mode)
        self.step = BlockStep(self.net, self.step.recipe, batch_size(ctx))
        self.stop = self.stopped = False

    def __call__(self, batch, mark=None):
        self.stopped = self.stop
        return super().__call__(batch, mark)


def control(ctx, state_dict):
    return BlockControl(ctx, state_dict)


def _drive_in_place(ctx: Context, world: int):
    """A stand-in program (the control) on the global batches in this
    process: the first steps, then the window; no workers, no trace."""
    import torch

    n_ref = ctx.traffic["reference_steps"]
    gb = [global_batch(ctx, j, world) for j in range(ctx.traffic["pool_batches"])]
    sd = weights.make(Arch.from_config(ctx.config["model"]), ctx.seed, ctx.device)
    program = ctx.program(ctx, sd)
    prog = train_step.first_steps(program, gb[:n_ref], sd)
    del sd
    steps = failed = 0
    t_start = time.perf_counter()
    while True:
        program.stop = time.perf_counter() >= t_start + ctx.seconds
        loss, gnorm = program(gb[(n_ref + steps) % len(gb)])
        steps += 1
        failed += not (math.isfinite(float(loss)) and math.isfinite(float(gnorm)))
        if program.stopped:
            break
    r = ctx.config["train"]
    rec = {"kind": "train", "setup_s": t_start - ctx.t0,
           "window_s": time.perf_counter() - t_start, "steps": steps,
           "frames": steps * world * r["batch_size"] * r["frame_length"], "attempted": steps,
           "failed": failed, "launches": {}, "window_peak_bytes": 0,
           "memory_peak_bytes": harness.peak_bytes(torch, ctx.device)}
    del program
    return rec, prog


def run(ctx: Context, fault=None) -> dict:
    """Rank 0: start the other ranks, take part in the run, collect their
    reports once they have ended, then check against the reference."""
    import torch

    world = ctx.traffic["ranks"]
    if ctx.program is not None:
        rec, prog = _drive_in_place(ctx, world)
    else:
        port_ddp.load_kernels(ctx.device)
        address = ranks.free_address()
        spec = _spec(ctx, world, address, fault)
        if ctx.device.type == "cpu":
            spec["threads"] = torch.get_num_threads()
        workers = ranks.Workers(spec, world, ctx.traffic["stall_s"])
        try:
            rec, prog = drive(ctx, 0, world, address, fault, workers.beat)
            reports = workers.finish(ctx.traffic["stall_s"])
        except BaseException:
            workers.kill()
            raise
        found = sorted({m for rep in reports for m in rep["forbidden"]})
        if found:
            ctx.log(f"JAX or the JAX package is loaded in a worker: {found}")
            raise SystemExit(3)
        if any(rep["steps"] != rec["steps"] for rep in reports):
            raise RuntimeError(f"the ranks ran {rec['steps']} and "
                               f"{[rep['steps'] for rep in reports]} steps")
        rec["memory_peak_bytes"] = max([rec["memory_peak_bytes"]]
                                       + [rep["memory_peak_bytes"] for rep in reports])
        rec["window_peak_bytes"] = max([rec["window_peak_bytes"]]
                                       + [rep["window_peak_bytes"] for rep in reports])
        rec["ranks"] = world
    harness.release(torch, ctx.device)
    t = time.perf_counter()
    n_ref = ctx.traffic["reference_steps"]
    rec["readings"] = train_step.readings(
        prog, follow(ctx, [global_batch(ctx, j, world) for j in range(n_ref)]))
    rec["check_s"] = time.perf_counter() - t
    return rec


def follow(ctx: Context, batches, mode: str = "fp32") -> dict:
    """The reference (``mode`` fp32) or the control (fp8) through the steps
    on the global ``batches``, in blocks of one rank's rows, from the
    seeded weights: ``train_step.follow``'s readings."""
    import torch

    arch = Arch.from_config(ctx.config["model"])
    net = RefNet(arch, mode=mode).to(ctx.device)
    p0 = weights.make(arch, ctx.seed, ctx.device)
    net.load_state_dict(p0)
    step = BlockStep(net, train_step.recipe(ctx), batch_size(ctx))
    out = {"loss": [], "grad_norm": []}
    with precision.fp32_matmuls():
        for b in batches:
            r = step(b)
            out["loss"].append(float(r["loss"]))
            out["grad_norm"].append(float(r["grad_norm"]))
    names = [n for n, _ in net.named_parameters()]
    out["grad_vec"] = {n: g.double().cpu() for n, g in zip(names, step.first_grads)}
    out["grad"] = {n: float(g.norm()) for n, g in out["grad_vec"].items()}
    out["change"] = {n: float((p.detach() - p0[n]).double().norm())
                     for n, p in net.named_parameters()}
    del net, step
    harness.release(torch, ctx.device)
    return out
