"""The stage table of a traced segment: the program's own spans, named
``tcs::<stage>`` in the trace, each with its host time, the device time and
launches launched inside it, and the device's idle time while the host was
inside it.

A frozen copy of the program's attribution (``tcs_tpu_torch/utils/
trace_summary.py``), so that a change to the program cannot move the
yardstick; it imports nothing of the program. Each device event (kernel,
memcpy, memset) inside the traced window is tied through its
``correlation`` id to the runtime call that launched it and goes to the
innermost span around that call on the launching thread. A launch inside
autograd's ``evaluate_function`` of a node goes to the span of the forward
op with that node's ``Sequence number``, or to :data:`BACKWARD` where no
span holds such an op. Any other launch, and a device event whose launch
is not in the trace, goes to :data:`NO_SPAN`. The window is the benchmark's
spans' (``bench::``), or the stages' where there are none; the device is
idle where no device event of the window runs, and each idle interval is
split by the innermost span on the thread that holds the benchmark's spans
(or most stage spans). A span's host time is its duration, spans nested in
it included. Times in µs.
"""

from __future__ import annotations

import collections

from benchmark.lib.trace import SPAN

PREFIX = "tcs::"
NO_SPAN = "(no span)"
BACKWARD = "backward"

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")
_EVALUATE = "autograd::engine::evaluate_function"


def _innermost(intervals, points) -> list:
    """For each time in ``points``, the name of the innermost of the
    properly nested ``intervals`` (start, end, name) that holds it, or
    None."""
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    order = sorted(range(len(points)), key=points.__getitem__)
    out, stack, i = [None] * len(points), [], 0
    for k in order:
        t = points[k]
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def _busy(device, t1) -> list:
    """The union of the device events' intervals, sorted, cut at ``t1``."""
    out = []
    for s, dur in sorted((d[0], d[1]) for d in device):
        e = min(s + dur, t1)
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _idle_by_span(spans, t0, t1, busy) -> collections.Counter:
    """The idle µs of [t0, t1] outside ``busy``, by the innermost of
    ``spans`` (one thread's) at each instant."""
    cuts = sorted({t0, t1, *(x for s, e, _ in spans for x in (s, e) if t0 < x < t1)})
    pieces = [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]
    owners = _innermost(spans, [0.5 * (a + b) for a, b in pieces])
    idle, k = collections.Counter(), 0
    for (a, b), owner in zip(pieces, owners):
        free = b - a
        while k < len(busy) and busy[k][1] <= a:
            k += 1
        j = k
        while j < len(busy) and busy[j][0] < b:
            free -= min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
        if free > 0:
            idle[owner or NO_SPAN] += free
    return idle


def summarize(events) -> dict:
    """``{span name: {"host_us", "device_us", "launches", "idle_us"}}`` of one
    trace's events, with a :data:`NO_SPAN` row (and a :data:`BACKWARD` row)
    for what no span holds; empty where the trace has no stage span."""
    stages, evaluates, forward_ops = (collections.defaultdict(list) for _ in range(3))
    bench, launch_at, device = [], {}, []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        cat, name, args = (e.get("cat") or "").lower(), e.get("name", "?"), e.get("args") or {}
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        where = (e.get("pid"), e.get("tid"))
        if cat == "user_annotation" and name.startswith(PREFIX):
            stages[where].append((ts, ts + dur, name[len(PREFIX):]))
        elif cat == "user_annotation" and name.startswith(SPAN):
            bench.append((ts, ts + dur, where))
        elif cat == "cpu_op" and "Sequence number" in args:
            if name.startswith(_EVALUATE):
                evaluates[where].append((ts, ts + dur, args["Sequence number"]))
            else:
                forward_ops[where].append((ts, args["Sequence number"]))
        elif cat in _LAUNCH and "correlation" in args:
            launch_at[args["correlation"]] = (where, ts)
        elif cat in _DEVICE:
            device.append((ts, dur, args.get("correlation")))
    if not stages:
        return {}
    if bench:
        t0, t1 = min(b[0] for b in bench), max(b[1] for b in bench)
        host = bench[0][2]
    else:
        every = [sp for spans in stages.values() for sp in spans]
        t0, t1 = min(s for s, _, _ in every), max(e for _, e, _ in every)
        host = max(stages, key=lambda w: len(stages[w]))
    device = [d for d in device if t0 <= d[0] <= t1]

    seq_stage = {}
    for where, ops in forward_ops.items():
        for (_, seq), owner in zip(ops, _innermost(stages[where], [t for t, _ in ops])):
            if owner is not None:
                seq_stage.setdefault(seq, owner)
    queries = collections.defaultdict(list)  # thread → [(launch time, device event index)]
    for k, (_, _, corr) in enumerate(device):
        if corr in launch_at:
            where, t = launch_at[corr]
            queries[where].append((t, k))
    owner_of = [NO_SPAN] * len(device)
    for where, q in queries.items():
        times = [t for t, _ in q]
        seqs = _innermost(evaluates[where], times)
        for (_, k), owner, seq in zip(q, _innermost(stages[where], times), seqs):
            if owner is not None:
                owner_of[k] = owner
            elif seq is not None:
                owner_of[k] = seq_stage.get(seq, BACKWARD)

    table = collections.defaultdict(
        lambda: {"host_us": 0.0, "device_us": 0.0, "launches": 0, "idle_us": 0.0})
    for spans in stages.values():
        for s, e, name in spans:
            table[name]["host_us"] += e - s
    for (_, dur, _), owner in zip(device, owner_of):
        table[owner]["device_us"] += dur
        table[owner]["launches"] += 1
    for owner, us in _idle_by_span(stages[host], t0, t1, _busy(device, t1)).items():
        table[owner]["idle_us"] += us
    return {name: dict(row) for name, row in table.items()}
