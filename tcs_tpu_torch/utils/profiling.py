"""Step timing and device memory (the port's copy of ``StepTimer`` and
``device_memory_stats`` of ``tcs_tpu/utils/profiling.py``)."""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


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
