"""Batch times frames of every step completed in the window, over the window's seconds (the window ends with a synchronize)."""

from benchmark.lib import readings


def read(record):
    return readings.frames_per_s(record, "train")
