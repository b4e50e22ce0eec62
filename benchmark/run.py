"""Run one cell of the benchmark of ``tcs_tpu_torch`` once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``benchmark/configs/<config>.json``) and a traffic
mix (``benchmark/traffic/<traffic>.json``), whose ``driver`` names the code
that drives it (``benchmark/drivers/<driver>.py``); each metric the cell
reports is read by ``benchmark/metrics/<metric>.py``, and each number the
check compares has its limit in ``benchmark/limits/<cell>.json``. One
process: set-up, warm-up, a window of ``--seconds``, with ``--trace 1`` a
traced segment after it, then the check against the plain reference. The
last line of standard output is one JSON object; with ``--trace 0`` its
metrics are the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics. Without a CUDA card the run exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries the cell reports in this run."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, record: dict):
    from benchmark.lib import harness

    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(record)


def result(bench: dict, cell: dict, record: dict, limits: dict, trace: bool, dev: dict) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, with a trace ``breakdown``, and last the numbers compared with
    their limits (``checks``)."""
    from benchmark.lib import harness
    from benchmark.lib import trace as tracing

    metrics = {}
    for m in metrics_for(bench, cell["name"], trace):
        value = read_metric(m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = harness.judged(record["readings"], limits)
    checks["failed_calls"] = {"value": record["failed"], "limit": 0}
    out = {"correct": harness.passes(checks), "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics, "device": dev}
    if trace:
        s = record["traced"]["summary"]
        dev["busy_s"] = s["busy_us"] * 1e-6
        dev["window_s"] = s["window_us"] * 1e-6
        out["breakdown"] = tracing.breakdown(s, record["traced"]["host_summary"])
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from benchmark.lib import device, harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    smi = device.card_line()
    traffic = harness.load_json(f"benchmark/traffic/{cell['traffic']}.json")
    ctx = harness.Context(
        cell=cell["name"], config=harness.load_json(f"benchmark/configs/{cell['config']}.json"),
        traffic=traffic, limits=harness.load_json(f"benchmark/limits/{cell['name']}.json"),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), t0=T0)
    driver = harness.load_module(harness.BENCH / "drivers" / f"{traffic['driver']}.py")
    record = driver.run(ctx)

    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package is loaded in the process: {found}", file=sys.stderr)
        return 3

    needed = record.get("launches_needed")
    print(f"hand-kernel launches in the window: {record['launches']}; the traffic needs "
          f"{needed}", flush=True)
    if not args.trace:
        mfu = {m["name"]: read_metric(m["name"], record)
               for m in metrics_for(bench, cell["name"], True) if m["name"].startswith("mfu")}
        print(f"window: {record['frames']} frames in {record['window_s']:.4f} s; {mfu}",
              flush=True)
    if args.trace:
        t = record["traced"]
        print(f"traced {t['calls']} calls in {t['summary']['window_us'] * 1e-6:.4f} s "
              f"(with the host's operators {t['host_summary']['window_us'] * 1e-6:.4f} s); "
              f"trace files {t['trace_bytes']} bytes; hand-kernel launches {t['launches']}",
              flush=True)
    print(f"readings {json.dumps(record['readings'])}; check {record['check_s']:.2f} s",
          flush=True)
    out = result(bench, cell, record, ctx.limits, bool(args.trace),
                 device.describe(torch, cell["chips"], record["memory_peak_bytes"], smi))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
