"""Readings for the limits of a data-parallel cell
(``benchmark/limits/<cell>.json``), on the cards at the cell's own size.

    python3 benchmark/calibrate_ddp.py --workload <cell> --seeds <n> [<n> ...] \
        [--faults F [F ...]] [--fault-seeds K] [--steps N [--anomaly-from S]] \
        [--set KEY=VALUE ...] [--out FILE]

One process group for every seed: rank 0 is this process, ranks 1 to W−1
are spawned as in a run (:mod:`benchmark.lib.ranks`). For each seed every
rank builds the program as a run does and drives its first steps (no
window); with ``--steps N`` it then goes on for N steps, cycling its pool,
and rank 0 notes the first step whose loss or gradient norm is not finite;
from step S on autograd's anomaly mode names the first backward operation
that returns a NaN (the rank that meets it ends the run with its trace).
For the first K seeds every rank does the same again with each fault of
``--faults`` planted (:mod:`benchmark.lib.ddp_faults`); ``control`` there
is the reference in fp8 on rank 0 alone. Rank 0 then runs the reference
once and reads every side against it. Each reading is one JSON line on
standard output (and appended to ``--out``). ``--set`` changes a key of the
configuration's ``model`` object (a witness: ``mixed_precision=false``). A
cell that ``BENCHMARK.json`` does not hold yet is read from its entries in
``benchmark/parked/<cell>.json``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _sides(spec: dict, i: int) -> list:
    """The programs run on the cards for the i-th seed: the port, then the
    planted faults on the first seeds."""
    faults = [f for f in spec["faults"] if f != "control"] if i < spec["fault_seeds"] else []
    return [None] + faults


def _context(spec: dict, seed: int, device):
    from benchmark.lib.harness import Context

    return Context(cell=spec["cell"], config=spec["config"], traffic=spec["traffic"], limits={},
                   seed=seed, seconds=0.0, trace=False, device=device, t0=time.perf_counter())


def _run_sides(spec: dict, rank: int, device, beat=lambda: None):
    """Every seed's sides on this rank, yielding (seed index, seed, side,
    first steps' readings, the long run's losses and norms) once each side
    has ended."""
    import torch

    from benchmark.drivers import train_ddp
    from benchmark.lib import harness, port_ddp

    port_ddp.initialize(spec["address"], spec["world"], rank, device)
    try:
        for i, seed in enumerate(spec["seeds"]):
            ctx = _context(spec, seed, device)
            for side in _sides(spec, i):
                program, batches, prog = train_ddp.prepare(ctx, rank, spec["world"], side)
                beat()
                long = []
                if side is None:
                    n_ref = ctx.traffic["reference_steps"]
                    for s in range(spec["steps"]):
                        if spec["anomaly_from"] is not None:
                            torch.autograd.set_detect_anomaly(
                                n_ref + s >= spec["anomaly_from"], check_nan=True)
                        loss, gnorm = program(batches[(n_ref + s) % len(batches)])
                        long.append((float(loss), float(gnorm)))
                        beat()
                del program, batches
                harness.release(torch, device)
                yield i, seed, side, prog, long
    finally:
        port_ddp.destroy()


def rank_main(spec: dict, rank: int) -> dict:
    import torch

    for _ in _run_sides(spec, rank, torch.device("cuda", rank)):
        pass
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--anomaly-from", type=int)
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark.drivers import train_ddp, train_step
    from benchmark.lib import ddp_faults, harness, port_ddp, ranks

    bad = set(args.faults) - set(ddp_faults.FAULTS) - {"control"}
    if bad:
        print(f"no such fault: {sorted(bad)}", file=sys.stderr)
        return 2
    cells = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
    parked = ROOT / "benchmark" / "parked" / f"{args.workload}.json"
    if parked.is_file():
        cells += json.loads(parked.read_text())["workloads"]
    cell = {w["name"]: w for w in cells}.get(args.workload)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json or benchmark/parked/",
              file=sys.stderr)
        return 2
    traffic = harness.load_json(f"benchmark/traffic/{cell['traffic']}.json")
    config = harness.load_json(f"benchmark/configs/{cell['config']}.json")
    for item in args.set:
        key, value = item.split("=", 1)
        config["model"][key] = json.loads(value)
    world = traffic["ranks"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"calibration runs on {world} cards", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    port_ddp.load_kernels(dev)
    spec = {"entry": "calibrate_ddp.py", "cell": cell["name"], "traffic": traffic,
            "config": config, "seeds": args.seeds, "faults": args.faults,
            "fault_seeds": args.fault_seeds, "steps": args.steps,
            "anomaly_from": args.anomaly_from, "world": world,
            "address": ranks.free_address()}
    workers = ranks.Workers(spec, world, traffic["stall_s"])

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")

    try:
        pending, t = {}, time.perf_counter()
        for i, seed, side, prog, long in _run_sides(spec, 0, dev, workers.beat):
            pending[side] = (prog, long)
            if side != _sides(spec, i)[-1]:
                continue
            ctx = _context(spec, seed, dev)
            n_ref = traffic["reference_steps"]
            gb = [train_ddp.global_batch(ctx, j, world) for j in range(n_ref)]
            ref = train_ddp.follow(ctx, gb)
            workers.beat()
            if "control" in args.faults and i < args.fault_seeds:
                pending["control"] = (train_ddp.follow(ctx, gb, "fp8"), [])
                workers.beat()
            for name, (p, lg) in pending.items():
                line = {"cell": cell["name"], "side": name or "program", "seed": seed,
                        "set": args.set,
                        "readings": train_step.readings(p, ref), "losses": p["loss"],
                        "grad_norms": p["grad_norm"], "ref_losses": ref["loss"],
                        "ref_grad_norms": ref["grad_norm"]}
                if lg:
                    bad_steps = [s for s, (a, b) in enumerate(lg)
                                 if not (math.isfinite(a) and math.isfinite(b))]
                    line["long"] = {"steps": len(lg), "non_finite": len(bad_steps),
                                    "first_non_finite": bad_steps[0] + n_ref if bad_steps
                                    else None, "last_loss": lg[-1][0],
                                    "max_grad_norm": max(b for _, b in lg)}
                line["seconds"] = time.perf_counter() - t
                line["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
                emit(line)
            pending, t = {}, time.perf_counter()
            del gb, ref
            harness.release(torch, dev)
        workers.finish(traffic["stall_s"])
    except BaseException:
        workers.kill()
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
