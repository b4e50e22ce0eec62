"""The traced segment of a run: ``torch.profiler`` over the CPU and the card,
the benchmark's own spans around its calls into the program, and the
reduction of the Chrome trace to what the per-layer metrics read.

Device events are kernels, memcpys and memsets. Each kernel gets a family
by the first matching substring of its lower-cased name (:data:`FAMILIES`,
copied from ``tcs_tpu_torch/utils/trace_summary.py``). The traced window
runs from the start of the first benchmark span to the end of the last; the
device is busy where any device event runs, and an idle gap is labelled by
what the host was doing at its middle: the innermost benchmark span and the
outermost operator (``aten::…``) running on the launching thread, or else on
another thread (autograd's), or ``python`` where none runs.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile

SPAN = "bench::"

FAMILIES = (("corr_lookup_bwd", "corr_lookup_bwd"), ("corr_lookup", "corr_lookup"),
            ("splat_sum_bwd", "splat_sum_bwd"), ("splat_sum", "splat_sum"),
            ("dgrad", "conv backward"), ("wgrad", "conv backward"),
            ("bwd", "conv backward"), ("backward", "backward elementwise/other"),
            ("conv", "conv"), ("cudnn", "conv"), ("xmma", "conv"), ("sm90", "gemm/conv"),
            ("gemm", "gemm/conv"), ("cutlass", "gemm/conv"), ("multi_tensor", "optimizer"),
            ("reduce", "reduce"), ("elementwise", "elementwise"),
            ("index", "index/gather/scatter"), ("gather", "index/gather/scatter"),
            ("scatter", "index/gather/scatter"), ("cat", "copy/cat"), ("copy", "copy/cat"))
CONV_FAMILIES = ("conv", "conv backward", "gemm/conv")
HAND_KERNELS = ("corr_lookup", "splat_sum")

_DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "other"


def span(name: str):
    """A benchmark span, named ``bench::<name>`` in the trace."""
    import torch

    return torch.profiler.record_function(SPAN + name)


@contextlib.contextmanager
def profiled(holder: dict, host: bool):
    """Profile the block, the card's activity and, with ``host``, the host's
    operators and the benchmark's spans; on the way out the trace is written
    to a file in the temporary directory, reduced by :func:`summarize` into
    ``holder["summary"]``, and deleted. Recording the host's operators costs
    the host time (a training step takes twice as long), so the device's
    numbers come from a trace without them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        yield prof
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder["trace_bytes"] = os.path.getsize(path)
        with open(path) as fh:
            holder["summary"] = summarize(json.load(fh).get("traceEvents", []))
    finally:
        os.unlink(path)


def _outermost(intervals):
    """The intervals that no earlier-starting one encloses, sorted."""
    out = []
    for s, e, name in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        if out and s < out[-1][1] and e <= out[-1][1]:
            continue
        out.append((s, e, name))
    return out


def _at(intervals_sorted, starts, t):
    """The interval of a sorted, non-overlapping list that holds ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and intervals_sorted[i][1] >= t:
        return intervals_sorted[i][2]
    return None


def _innermost(spans, t):
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or s >= best[0]):
            best = (s, e, name)
    return best[2] if best else None


def summarize(events) -> dict:
    """The reduction of a trace's events: device events (name, family, kind,
    start µs, duration µs) inside the window, the window, the busy time and
    the idle gaps labelled by the host's work. Times in µs."""
    spans, ops_by_thread, device, launch_ts = [], collections.defaultdict(list), [], []
    span_thread = None
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        cat = (e.get("cat") or "").lower()
        name = e.get("name", "?")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        where = (e.get("pid"), e.get("tid"))
        if cat == "user_annotation" and name.startswith(SPAN):
            spans.append((ts, ts + dur, name[len(SPAN):]))
            span_thread = where
        elif cat == "cpu_op":
            ops_by_thread[where].append((ts, ts + dur, name))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launch_ts.append(ts)
        elif cat in _DEVICE_CATS:
            device.append((name, family(name) if cat == "kernel" else _DEVICE_CATS[cat],
                           _DEVICE_CATS[cat], ts, dur))
    if spans:
        t0, t1 = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    elif device:  # no host activity: from the first launch to the last device event's end
        t0 = min(launch_ts + [d[3] for d in device])
        t1 = max(d[3] + d[4] for d in device)
    else:
        return {"window_us": 0.0, "busy_us": 0.0, "device": [], "gaps": [], "spans": {}}
    device = [d for d in device if d[3] >= t0 and d[3] <= t1]
    device.sort(key=lambda d: d[3])

    busy, gaps = 0.0, []
    # The launching thread first, then the others (autograd's backward runs
    # on a thread of its own).
    threads = sorted(ops_by_thread, key=lambda w: w != span_thread)
    ops = [_outermost(ops_by_thread[w]) for w in threads]
    starts = [[s for s, _, _ in o] for o in ops]

    def host_op(t):
        for o, st in zip(ops, starts):
            name = _at(o, st, t)
            if name is not None:
                return name
        return "python"
    cur_s = cur_e = None
    intervals = []
    for _, _, _, s, dur in device:
        e = min(s + dur, t1)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                intervals.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        intervals.append((cur_s, cur_e))
    edges = [t0] + [x for iv in intervals for x in iv] + [t1]
    for k in range(0, len(edges), 2):
        a, b = edges[k], edges[k + 1]
        if b > a:
            mid = 0.5 * (a + b)
            gaps.append((f"{_innermost(spans, mid) or 'outside spans'} / {host_op(mid)}", b - a))
    busy = sum(e - s for s, e in intervals)
    span_time = collections.Counter()
    for s, e, name in spans:
        span_time[name] += e - s
    return {"window_us": t1 - t0, "busy_us": busy, "device": device, "gaps": gaps,
            "spans": dict(span_time)}


def breakdown(summary: dict, host_summary: dict, top: int = 10) -> dict:
    """The device operations that took most time (``summary``) and the idle
    time by the host's work (``host_summary``, a trace with the host's
    operators), in seconds, each list at most ``top`` long."""
    ops = collections.Counter()
    for name, fam, _, _, dur in summary["device"]:
        ops[f"{fam}: {name[:120]}"] += dur * 1e-6
    gaps = collections.Counter()
    for label, dur in host_summary["gaps"]:
        gaps[label] += dur * 1e-6
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}
