"""Every frame of every stream completed in the window, over the window's seconds."""

from benchmark.lib import readings


def read(record):
    return readings.frames_per_s(record, "stream")
