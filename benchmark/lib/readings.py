"""The arithmetic of the metric readers (``benchmark/metrics/<name>.py``).

Each reader is given the run's record and returns a number, or ``None``
where its cell's record holds nothing for it (another kind of traffic, or
no trace): the harness then leaves the metric out. A share of a peak or of
a roofline is never made 0 for want of a reading.
"""

from __future__ import annotations

import statistics

from benchmark.lib import trace
from benchmark.lib.device import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S


def window(record: dict, kind: str):
    return record if record.get("kind") == kind and record.get("window_s", 0) > 0 else None


def traced(record: dict, kind: str):
    t = record.get("traced") if record.get("kind") == kind else None
    return t if t and t["summary"]["window_us"] > 0 else None


def frames_per_s(record: dict, kind: str):
    r = window(record, kind)
    return None if r is None else r["frames"] / r["window_s"]


def p95_ms(latencies_s) -> float:
    """The 95th percentile (inclusive quantiles) of the calls' times, ms."""
    if len(latencies_s) < 2:
        return None
    return 1e3 * statistics.quantiles(latencies_s, n=100, method="inclusive")[94]


def mfu_pct(record: dict, kind: str):
    """The benchmark's FLOP count of the window's work over the window's
    seconds, as a share of the dense bf16 peak."""
    r = window(record, kind)
    if r is None or not r.get("window_flops"):
        return None
    return 100.0 * r["window_flops"] / r["window_s"] / PEAK_BF16_FLOPS


def device_events_per_call(record: dict, kind: str):
    t = traced(record, kind)
    return None if t is None else len(t["summary"]["device"]) / t["calls"]


def copy_ms_per_call(record: dict, kind: str):
    """Device time of host-to-device and device-to-host copies a call."""
    t = traced(record, kind)
    if t is None:
        return None
    us = sum(d[4] for d in t["summary"]["device"]
             if d[2] == "memcpy" and ("HtoD" in d[0] or "DtoH" in d[0]))
    return us / 1e3 / t["calls"]


def conv_roofline_pct(record: dict, kind: str):
    """The count's convolutions and products of the traced calls over the
    device time of the conv, conv-backward and gemm kernels, as a share of
    the bf16 peak."""
    t = traced(record, kind)
    if t is None:
        return None
    us = sum(d[4] for d in t["summary"]["device"] if d[1] in trace.CONV_FAMILIES)
    if us <= 0:
        return None
    return 100.0 * t["dense_flops"] / (us * 1e-6) / PEAK_BF16_FLOPS


def hand_roofline_pct(record: dict, kind: str):
    """The hand kernels' byte bound at the HBM rate over their device time."""
    t = traced(record, kind)
    if t is None:
        return None
    us = sum(d[4] for d in t["summary"]["device"]
             if d[2] == "kernel" and any(k in d[0] for k in trace.HAND_KERNELS))
    if us <= 0 or not t["hand_bytes"]:
        return None
    return 100.0 * t["hand_bytes"] / PEAK_HBM_BYTES_PER_S / (us * 1e-6)


def idle_pct(record: dict, kind: str):
    """The share of the traced window in which no device event runs."""
    t = traced(record, kind)
    if t is None:
        return None
    s = t["summary"]
    return 100.0 * (1.0 - s["busy_us"] / s["window_us"])
