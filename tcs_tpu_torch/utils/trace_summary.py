"""Per-op, per-module and per-family device time from a ``torch.profiler``
trace (the port's counterpart of ``tcs_tpu/utils/trace_summary.py``).

Only device events count: kernels, memcpy and memset (kineto's ``kernel``,
``gpu_memcpy`` and ``gpu_memset``). Each is attributed through its
``correlation`` id to the CUDA runtime (or driver) call that launched it,
and from that call's thread and time:

- ``by_op``: the kernel's name (``Memcpy HtoD …`` and the like for copies);
- ``by_category``: the kernel's family (:data:`FAMILIES`, first match, plus
  ``memcpy`` and ``memset``);
- ``by_module``: the innermost module range (:func:`profiling.trace` with a
  model pushes one per submodule call, named by its ``named_modules()``
  path) around the launching call. A launch in the backward (inside
  autograd's ``evaluate_function`` of some node) goes to the module of the
  forward op with that node's ``Sequence number``, which is how the trace
  links the two; where no forward op in a module range has it, to
  ``backward``. A launch outside both is :data:`NO_MODULE`;
- ``by_stage``: the same for the innermost stage range
  (:func:`profiling.span`, named ``tcs::<stage>``) around the launching
  call, backward launches by the same sequence number; a launch outside
  every stage is :data:`NO_STAGE`.

``jit_ms`` keeps ``tcs_tpu``'s field name; here it is the time of the
top-level user ranges (``record_function`` blocks other than module and
stage ranges that no other user range on their thread encloses), by name.

Shared by ``scripts/profile_torch_main_path.py``,
``scripts/profile_torch_train_step.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys
from dataclasses import dataclass, field

MODULE_RANGE = "module::"  # the prefix of the ranges profiling.trace pushes
STAGE_RANGE = "tcs::"  # the prefix of profiling.span's ranges
NO_MODULE = "(no module)"
NO_STAGE = "(no stage)"
BACKWARD = "backward"

# Kernel families by substring of the lower-cased name, first match wins.
FAMILIES = (("corr_lookup_bwd", "corr_lookup_bwd"), ("corr_lookup", "corr_lookup"),
            ("splat_sum_bwd", "splat_sum_bwd"), ("splat_sum", "splat_sum"),
            ("dgrad", "conv backward"), ("wgrad", "conv backward"),
            ("bwd", "conv backward"), ("backward", "backward elementwise/other"),
            ("conv", "conv"), ("cudnn", "conv"), ("xmma", "conv"), ("sm90", "gemm/conv"),
            ("gemm", "gemm/conv"), ("cutlass", "gemm/conv"), ("multi_tensor", "optimizer"),
            ("reduce", "reduce"), ("elementwise", "elementwise"),
            ("index", "index/gather/scatter"), ("gather", "index/gather/scatter"),
            ("scatter", "index/gather/scatter"), ("cat", "copy/cat"), ("copy", "copy/cat"))

_DEVICE = {"kernel": None, "gpu_memcpy": "memcpy", "memcpy": "memcpy",
           "gpu_memset": "memset", "memset": "memset"}
_LAUNCH = ("cuda_runtime", "runtime", "cuda_driver")
_EVALUATE = "autograd::engine::evaluate_function"


def family(kernel: str) -> str:
    low = kernel.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "other"


@dataclass
class TraceSummary:
    total_ms: float = 0.0            # summed device-event time (all steps)
    by_op: collections.Counter = field(default_factory=collections.Counter)
    by_module: collections.Counter = field(default_factory=collections.Counter)
    by_category: collections.Counter = field(default_factory=collections.Counter)
    jit_ms: dict = field(default_factory=dict)  # top-level user ranges, ms by name
    launches: collections.Counter = field(default_factory=collections.Counter)  # events by op
    module_launches: collections.Counter = field(default_factory=collections.Counter)  # by module
    by_stage: collections.Counter = field(default_factory=collections.Counter)
    stage_launches: collections.Counter = field(default_factory=collections.Counter)
    category_launches: collections.Counter = field(default_factory=collections.Counter)

    @property
    def events(self) -> int:
        return sum(self.launches.values())

    @property
    def unattributed_ms(self) -> float:
        return self.by_module.get(NO_MODULE, 0.0)


def latest_trace_path(logdir: str) -> str | None:
    paths = [p for pattern in ("*.trace.json.gz", "*.trace.json")
             for p in glob.glob(os.path.join(logdir, "**", pattern), recursive=True)]
    return max(paths, key=os.path.getmtime) if paths else None


def _innermost(intervals, points) -> list:
    """For each time in ``points``, the payload of the innermost of the
    properly nested ``intervals`` (start, end, payload) that holds it, or
    None; one thread's events."""
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


def _span(e) -> tuple:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def summarize(events, strip_prefixes: tuple = ()) -> TraceSummary:
    """The tables of one trace's ``traceEvents``."""
    s = TraceSummary()
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
    # by (pid, tid): module ranges, stage ranges, backward nodes, forward ops, user ranges
    ranges, stages, evaluates, forward_ops, users = (collections.defaultdict(list)
                                                     for _ in range(5))
    launch_at = {}  # correlation id → (thread, time) of the launching call
    for e in complete:
        cat, name, args = (e.get("cat") or "").lower(), e.get("name", "?"), e.get("args") or {}
        where = (e.get("pid"), e.get("tid"))
        if cat == "user_annotation":
            if name.startswith(MODULE_RANGE):
                path = name[len(MODULE_RANGE):]
                for p in strip_prefixes:
                    path = path.replace(p, "")
                ranges[where].append((*_span(e), path))
            elif name.startswith(STAGE_RANGE):
                stages[where].append((*_span(e), name[len(STAGE_RANGE):]))
            else:
                users[where].append((*_span(e), name))
        elif cat in ("cpu_op", "operator") and "Sequence number" in args:
            if name.startswith(_EVALUATE):
                evaluates[where].append((*_span(e), args["Sequence number"]))
            else:
                forward_ops[where].append((float(e["ts"]), args["Sequence number"]))
        elif cat in _LAUNCH and "correlation" in args:
            launch_at[args["correlation"]] = (where, float(e["ts"]))

    # A forward op's module and stage; a sequence number names the op that
    # made an autograd node, and the nested ops it called share it.
    seq_module, seq_stage = {}, {}
    for where, ops in forward_ops.items():
        times = [t for t, _ in ops]
        for table, intervals in ((seq_module, ranges), (seq_stage, stages)):
            for (_, seq), owner in zip(ops, _innermost(intervals[where], times)):
                if owner is not None:
                    table.setdefault(seq, owner)

    device = [e for e in complete if (e.get("cat") or "").lower() in _DEVICE]
    queries = collections.defaultdict(list)  # thread → [(launch time, device event index)]
    for k, e in enumerate(device):
        at = launch_at.get((e.get("args") or {}).get("correlation"))
        if at is not None:
            queries[at[0]].append((at[1], k))
    module_of, stage_of = [NO_MODULE] * len(device), [NO_STAGE] * len(device)
    for where, q in queries.items():
        times = [t for t, _ in q]
        seqs = _innermost(evaluates[where], times)
        for out, intervals, by_seq in ((module_of, ranges, seq_module),
                                       (stage_of, stages, seq_stage)):
            for (_, k), owner, seq in zip(q, _innermost(intervals[where], times), seqs):
                if owner is not None:
                    out[k] = owner
                elif seq is not None:
                    out[k] = by_seq.get(seq, BACKWARD)
    for e, mod, stage in zip(device, module_of, stage_of):
        name, cat = e.get("name", "?"), _DEVICE[(e.get("cat") or "").lower()]
        ms = float(e.get("dur", 0.0)) / 1000.0
        s.by_op[name] += ms
        s.launches[name] += 1
        s.by_category[cat or family(name)] += ms
        s.category_launches[cat or family(name)] += 1
        s.by_module[mod] += ms
        s.module_launches[mod] += 1
        s.by_stage[stage] += ms
        s.stage_launches[stage] += 1
        s.total_ms += ms

    for where, spans in users.items():  # top level: no user range on the thread holds it
        spans.sort(key=lambda iv: (iv[0], -iv[1]))
        ends = []
        for start, end, name in spans:
            if ends and start <= ends[-1]:
                continue
            ends.append(end)
            s.jit_ms[name] = s.jit_ms.get(name, 0.0) + (end - start) / 1000.0
    return s


def summarize_trace(logdir: str, strip_prefixes: tuple = ()) -> TraceSummary:
    """Aggregate the newest trace under ``logdir``; empty where there is none."""
    path = latest_trace_path(logdir)
    if path is None:
        return TraceSummary()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        trace = json.load(fh)
    return summarize(trace.get("traceEvents", []), strip_prefixes)


def print_summary(s: TraceSummary, steps: int, top: int = 40, file=None):
    file = file or sys.stdout
    total = max(s.total_ms, 1e-9)
    print(f"device total {s.total_ms:.2f} ms over {steps} steps "
          f"→ {s.total_ms / steps:.2f} ms/step, {s.events / steps:.1f} device events/step; "
          f"{NO_MODULE} {100 * s.unattributed_ms / total:.1f} %", file=file)
    for title, counter, n in (("module", s.by_module, top), ("family", s.by_category, 15),
                              ("op", s.by_op, top)):
        print(f"\n{'ms/step':>9}  {'%':>5}  {title}", file=file)
        for name, ms in counter.most_common(n):
            print(f"{ms / steps:9.3f}  {100 * ms / total:5.1f}  {name[:110]}", file=file)
    print(f"\n{'ms/step':>9}  {'%':>5}  {'events/step':>11}  stage", file=file)
    for name, ms in s.by_stage.most_common():
        print(f"{ms / steps:9.3f}  {100 * ms / total:5.1f}  "
              f"{s.stage_launches[name] / steps:11.1f}  {name}", file=file)
