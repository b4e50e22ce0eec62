"""Device kernels, memcpys and memsets a step in the traced steps."""

from benchmark.lib import readings


def read(record):
    return readings.device_events_per_call(record, "train")
