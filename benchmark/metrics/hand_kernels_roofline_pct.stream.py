"""The hand kernels' byte bound (lib/bounds.py) at 3.35 TB/s over their device time in the traced calls."""

from benchmark.lib import readings


def read(record):
    return readings.hand_roofline_pct(record, "stream")
