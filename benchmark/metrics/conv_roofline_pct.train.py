"""Convolutions and products of the traced steps, by the benchmark's count, over the device time of conv, conv-backward and gemm kernels, as a share of the bf16 peak."""

from benchmark.lib import readings


def read(record):
    return readings.conv_roofline_pct(record, "train")
