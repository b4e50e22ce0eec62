"""The stage table (``benchmark/lib/stages.py``) on a recorded trace with the
program's spans (``fixtures/trace_stages.json``, answers worked out by hand)
and on a real CPU trace of the program's evaluator at a small size."""

import json
from pathlib import Path

from benchmark.drivers import stream
from benchmark.lib import stages, trace, weights
from benchmark.reference.model import Arch

FIXTURE = json.loads((Path(__file__).parent / "fixtures" / "trace_stages.json").read_text())


def test_stage_table_of_a_recorded_trace():
    assert stages.summarize(FIXTURE["traceEvents"]) == FIXTURE["stages"]


def test_the_benchmarks_own_summary_ignores_the_stage_spans():
    """Window, busy time, device events and idle gaps are those of the same
    trace without the program's spans."""
    events = FIXTURE["traceEvents"]
    bare = [e for e in events if not e["name"].startswith(stages.PREFIX)]
    assert trace.summarize(events) == trace.summarize(bare)
    assert stages.summarize(bare) == {}


def test_stage_table_of_a_cpu_trace_of_the_evaluator(small, tmp_path):
    """Two scenes' worth of calls of the program's evaluator traced on the
    CPU: every stage of a bootstrap and of a carried call is in the table,
    each call's spans once, ``model.iter`` once an iteration; with no device
    the idle time is the window's, split among the spans."""
    import torch

    ctx = small("kitti-stream", frames=2)
    inp = stream.make_inputs(ctx)
    program = stream.port_program(ctx, weights.make(Arch.from_config(ctx.config["model"]),
                                                    ctx.seed, ctx.device))
    stream.call(program, inp, 0)
    program.reset()
    path = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for k in range(2):
            with trace.span("stream.call.bootstrap" if k == 0 else "stream.call.carried"):
                stream.call(program, inp, k)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    table = stages.summarize(events)
    calls = [e for e in events if e.get("name", "").startswith(trace.SPAN)]
    window = max(e["ts"] + e["dur"] for e in calls) - min(e["ts"] for e in calls)
    names = {"eval.inputs", "eval.output", "model.frame", "model.encode", "model.cost_volume",
             "model.argmax", "model.warp", "model.context", "model.completion",
             "model.state_warp", "model.iter", "model.upsample"}
    assert names <= set(table) <= names | {stages.NO_SPAN}
    assert all(row["device_us"] == 0 and row["launches"] == 0 for row in table.values())
    assert all(row["host_us"] > 0 for name, row in table.items() if name in names)
    n_iter = sum(e["name"] == stages.PREFIX + "model.iter" for e in events)
    assert n_iter == 2 * ctx.config["stream"]["iters"]
    assert abs(sum(row["idle_us"] for row in table.values()) - window) < 1e-6 * window
    assert table["model.frame"]["host_us"] > sum(
        table[n]["host_us"] for n in names if n.startswith("model.") and n != "model.frame")
