"""Share of the traced calls' window in which no kernel, memcpy or memset runs."""

from benchmark.lib import readings


def read(record):
    return readings.idle_pct(record, "stream")
