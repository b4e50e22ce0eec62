"""The benchmark's FLOP count of the window's steps over the window's seconds, as a share of the dense bf16 peak (989 TFLOP/s)."""

from benchmark.lib import readings


def read(record):
    return readings.mfu_pct(record, "train")
