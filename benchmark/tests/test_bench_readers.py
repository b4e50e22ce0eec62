"""The metric readers and the result line on a small recorded trace
(``fixtures/trace_small.json``: two benchmark spans of 1 ms, four kernels
and two copies), with answers worked out by hand."""

import importlib.util
import json
from pathlib import Path

import pytest

from benchmark.lib import harness, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PEAK, HBM = 989e12, 3.35e12


def _summary():
    events = json.loads((Path(__file__).parent / "fixtures" / "trace_small.json").read_text())
    return trace.summarize(events["traceEvents"])


def _record(kind="stream"):
    return {"kind": kind, "setup_s": 12.5, "window_s": 2.0, "frames": 80, "calls": 10,
            "attempted": 10, "failed": 0, "latencies_s": [i / 1000 for i in range(1, 101)],
            "window_flops": 0.1 * PEAK * 2.0, "window_peak_bytes": 3 * 2**30,
            "memory_peak_bytes": 4 * 2**30, "readings": {"boot_rel": 0.01},
            "traced": {"calls": 2, "summary": _summary(), "host_summary": _summary(),
                       "trace_bytes": 1,
                       "dense_flops": 0.5 * PEAK * 300e-6, "hand_bytes": 0.25 * HBM * 150e-6,
                       "launches": {}}}


def _read(name, record):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(record)


def test_summary_window_busy_and_gaps():
    s = _summary()
    assert s["window_us"] == 2000 and s["busy_us"] == 800
    assert len(s["device"]) == 6  # the kernel after the last span is outside
    gaps = {}
    for label, us in s["gaps"]:
        gaps[label] = gaps.get(label, 0) + us
    assert gaps == {"stream.call.bootstrap / aten::to": 100,
                    "stream.call.bootstrap / python": 100 + 50 + 400,
                    "stream.call.carried / python": 100,
                    "stream.call.carried / aten::copy_": 450}


@pytest.mark.parametrize("name,want", [
    ("stream_frames_per_s", 40.0), ("setup_s", 12.5), ("mfu_pct.stream", 10.0),
    ("launches_per_call.stream", 3.0), ("copy_ms_per_call.stream", 0.125),
    ("conv_roofline_pct.stream", 50.0), ("hand_kernels_roofline_pct.stream", 25.0),
    ("device_idle_pct.stream", 60.0), ("stream_frame_ms_p95", 95.05)])
def test_stream_readers(name, want):
    assert _read(name, _record()) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name,want", [
    ("train_frames_per_s", 40.0), ("mfu_pct.train", 10.0), ("launches_per_step.train", 3.0),
    ("conv_roofline_pct.train", 50.0), ("hand_kernels_roofline_pct.train", 25.0),
    ("device_idle_pct.train", 60.0), ("peak_mem_gib.train", 3.0)])
def test_train_readers(name, want):
    assert _read(name, _record("train")) == pytest.approx(want, rel=1e-9)


def test_a_reader_with_nothing_to_read_returns_none():
    rec = _record("train")
    assert _read("stream_frames_per_s", rec) is None
    assert _read("conv_roofline_pct.stream", rec) is None
    rec["traced"] = None
    assert _read("device_idle_pct.train", rec) is None
    assert _read("hand_kernels_roofline_pct.train", dict(rec, traced=dict(
        _record("train")["traced"], hand_bytes=0.0))) is None


def _run_module():
    spec = importlib.util.spec_from_file_location("bench_run", ROOT / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    run = _run_module()
    cell = {w["name"]: w for w in BENCH["workloads"]}["kitti-stream"]
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 1}
    out = run.result(BENCH, cell, _record(), {"checks": {"boot_rel": {"limit": 0.05}}},
                     traced, dev)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert out["correct"] is True
    assert out["checks"] == {"boot_rel": {"value": 0.01, "limit": 0.05},
                             "failed_calls": {"value": 0, "limit": 0}}
    want = {m["name"] for m in BENCH["per_layer" if traced else "end_to_end"]
            if "kitti-stream" in m.get("workloads", ["kitti-stream"])}
    assert set(out["metrics"]) == want
    if traced:
        assert out["device"]["busy_s"] == pytest.approx(800e-6)
        assert out["device"]["window_s"] == pytest.approx(2000e-6)
        assert len(out["breakdown"]["device_ops"]) <= 10
        assert out["breakdown"]["idle_gaps"][0] == ["stream.call.bootstrap / python",
                                                     pytest.approx(550e-6)]
    json.dumps(out)


def test_a_reading_over_its_limit_or_a_failed_call_is_not_correct():
    run = _run_module()
    cell = {w["name"]: w for w in BENCH["workloads"]}["kitti-stream"]
    dev = {}
    assert not run.result(BENCH, cell, _record(), {"checks": {"boot_rel": {"limit": 0.005}}},
                          False, dev)["correct"]
    rec = dict(_record(), failed=1)
    assert not run.result(BENCH, cell, rec, {"checks": {"boot_rel": {"limit": 0.05}}},
                          False, dev)["correct"]
    rec = dict(_record(), readings={"boot_rel": float("nan")})
    assert not run.result(BENCH, cell, rec, {"checks": {"boot_rel": {"limit": 0.05}}},
                          False, dev)["correct"]
