"""Tracing, step timing and device memory (the port's copy of
``tcs_tpu/utils/profiling.py``).

- :func:`trace`: ``torch.profiler`` over the CPU and, where there is a GPU,
  the CUDA activities, written as a Chrome trace under a directory that
  :func:`tcs_tpu_torch.utils.trace_summary.summarize_trace` reads; with a
  model, one range a submodule call, named by its path;
- :func:`span`: a named stage of the program, a range in such a trace and
  nothing when no profiler records;
- :func:`device_ms`: a call's device time from such a trace;
- :class:`StepTimer`: a rolling wall-clock step timer;
- :func:`device_memory_stats`: the caching allocator's bytes on a GPU.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import socket
import time
from typing import Dict, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

from tcs_tpu_torch.utils.trace_summary import MODULE_RANGE, STAGE_RANGE, summarize_trace

_IDLE = contextlib.nullcontext()


def span(name: str):
    """A range named ``tcs::<name>`` around the block while a profiler
    records, on the trace's clock, so that the summary attributes each
    launch to its stage; otherwise one shared no-op context, so that a span
    costs the program one flag read."""
    if not _autograd_profiler._is_profiler_enabled:
        return _IDLE
    return _autograd_profiler.record_function(STAGE_RANGE + name)


def _module_ranges(model: torch.nn.Module) -> list:
    """Hooks that push a profiler range named ``module::<path>`` (the root:
    its class name) around each submodule's forward; returns their handles."""
    handles = []
    for path, mod in model.named_modules():
        label = MODULE_RANGE + (path or type(model).__name__)
        open_ranges = []

        def enter(_mod, _args, label=label, open_ranges=open_ranges):
            rf = torch.autograd.profiler.record_function(label)
            rf.__enter__()
            open_ranges.append(rf)

        def leave(_mod, _args, _out, open_ranges=open_ranges):
            if open_ranges:
                open_ranges.pop().__exit__(None, None, None)

        handles.append(mod.register_forward_pre_hook(enter))
        handles.append(mod.register_forward_hook(leave, always_call=True))
    return handles


@contextlib.contextmanager
def trace(logdir: str, model: Optional[torch.nn.Module] = None):
    """Profile the block (CPU ops and, on a GPU, its kernels, copies and
    fills) and write ``<logdir>/<host>_<pid>.<ns>.pt.trace.json.gz``. With
    ``model``, each submodule call is a range named by its
    ``named_modules()`` path; the hooks exist only inside the block, so the
    model runs outside it exactly as without them. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handles = _module_ranges(model) if model is not None else []
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        for h in handles:
            h.remove()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json.gz"))


TIMED = "timed calls"  # device_ms's range


def device_ms(fn, logdir: str, calls: int = 4) -> Tuple[float, float]:
    """(ms, device events) a call of ``fn`` on the card: the kernels', copies'
    and fills' time launched inside a range around ``calls`` calls, summed
    from a :func:`trace` written under ``logdir`` (emptied first), after a
    call outside the trace and one inside it but outside the range. Host
    work and the device's waits between launches are not in it. A trace of
    a hand kernel's launches alone has held only some of them: time such a
    call with CUDA events instead."""
    shutil.rmtree(logdir, ignore_errors=True)
    fn()
    with trace(logdir):
        fn()
        torch.cuda.synchronize()
        with torch.autograd.profiler.record_function(MODULE_RANGE + TIMED):
            for _ in range(calls):
                fn()
        torch.cuda.synchronize()
    s = summarize_trace(logdir)
    return s.by_module[TIMED] / calls, s.module_launches[TIMED] / calls


class StepTimer:
    """Rolling step timer; the first ``skip`` steps (a new shape's cuDNN
    choices and the allocator's first pools) are left out."""

    def __init__(self, skip: int = 2, window: int = 100):
        self.skip = skip
        self.window = window
        self._times = []
        self._last: Optional[float] = None
        self._count = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.skip:
                self._times.append(now - self._last)
                if len(self._times) > self.window:
                    self._times.pop(0)
        self._last = now

    @property
    def mean_step_seconds(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    @property
    def steps_per_second(self) -> float:
        m = self.mean_step_seconds
        return 1.0 / m if m == m and m > 0 else float("nan")


def device_memory_stats(device: torch.device) -> Dict[str, int]:
    """Bytes allocated now and at the peak, and reserved by the caching
    allocator, on a CUDA device; empty for the CPU."""
    if device.type != "cuda":
        return {}
    return {"allocated": torch.cuda.memory_allocated(device),
            "peak_allocated": torch.cuda.max_memory_allocated(device),
            "reserved": torch.cuda.memory_reserved(device)}
