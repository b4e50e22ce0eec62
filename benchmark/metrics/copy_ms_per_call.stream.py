"""Device time of host-to-device and device-to-host copies a call in the traced calls."""

from benchmark.lib import readings


def read(record):
    return readings.copy_ms_per_call(record, "stream")
