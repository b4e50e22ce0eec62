"""Share of the traced steps' window in which no kernel, memcpy or memset runs."""

from benchmark.lib import readings


def read(record):
    return readings.idle_pct(record, "train")
