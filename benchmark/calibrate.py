"""Readings for the limits of ``benchmark/limits/<cell>.json``, on the card at
the cell's own size: the program's readings over many seeds (the lower
reading of each number), the control's (the reference in fp8 put in the
program's place; the upper reading) and, for a training cell, the fault of
half the batch left out.

    python3 benchmark/calibrate.py --workload <cell> --side program|control|half \
        --seeds <n> [<n> ...] [--out FILE]

One process for all the seeds: each seed's inputs and weights are made
anew, the side drives the cell's timed call only as far as the check needs
(no window), and the check runs as in a run. Each seed's readings are one
JSON line on standard output (and appended to ``--out``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


class HalfBatch:
    """A training step that leaves out half of the batch and takes its means
    over the rest: the fault the check must catch."""

    def __init__(self, step):
        self.step = step

    def __call__(self, batch, mark=None):
        import dataclasses

        half = batch.image1.shape[0] // 2
        cut = dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[:half]
                                            for f in dataclasses.fields(batch)})
        return self.step(cut, mark)

    def __getattr__(self, name):
        return getattr(self.step, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control", "half"), default="program")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import control, harness, port, weights
    from benchmark.reference.model import Arch

    if not torch.cuda.is_available():
        print("calibration runs on the card", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    traffic = harness.load_json(f"benchmark/traffic/{cell['traffic']}.json")
    config = harness.load_json(f"benchmark/configs/{cell['config']}.json")
    driver = harness.load_module(harness.BENCH / "drivers" / f"{traffic['driver']}.py")
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = harness.Context(cell=cell["name"], config=config, traffic=traffic, limits={},
                              seed=seed, seconds=0.0, trace=False, device=dev, t0=t)
        sd = weights.make(Arch.from_config(config["model"]), seed, dev)
        line = {"cell": cell["name"], "side": args.side, "seed": seed}
        if traffic["driver"] == "stream":
            inp = driver.make_inputs(ctx)
            program = (control.stream if args.side == "control" else driver.port_program)(ctx, sd)
            rec = driver.drive(ctx, program, inp, 0.0)
            del program
            harness.release(torch, dev)
            line["readings"] = driver.check(ctx, inp, rec["kept"], rec["sample"])
            line["sample"] = rec["sample"]
        else:
            pool = driver.make_pool(ctx)
            if args.side == "control":
                program, batches = control.train(ctx, sd), pool
            else:
                program, batches = driver.port_program(ctx, sd), [port.batch(b) for b in pool]
                if args.side == "half":
                    program = HalfBatch(program)
            n = traffic["reference_steps"]
            prog = driver.first_steps(program, batches[:n], sd)
            del program, batches
            harness.release(torch, dev)
            line["readings"] = driver.check(ctx, pool[:n], prog)
            line["losses"] = prog["loss"]
        line["seconds"] = time.perf_counter() - t
        line["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")
        del sd
        harness.release(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
