"""Seconds from the process's start to the window's start: imports, CUDA, the kernel library (built on a checkout's first run), seeded weights and inputs, warm-up."""

from benchmark.lib import readings


def read(record):
    return record.get("setup_s")
