"""The 95th percentile, over all calls of the window, of a call's time from
its start to all its streams' disparities in host memory."""

from benchmark.lib import readings


def read(record):
    r = readings.window(record, "stream")
    return None if r is None else readings.p95_ms(r["latencies_s"])
