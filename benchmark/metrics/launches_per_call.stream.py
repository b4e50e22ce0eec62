"""Device kernels, memcpys and memsets a call in the traced calls."""

from benchmark.lib import readings


def read(record):
    return readings.device_events_per_call(record, "stream")
