"""The arithmetic of the readers of the gradients' exchange between cards:
NCCL's kernels on rank 0's card in the traced steps, matched by name (the
trace's families file them with the reductions), per step. No roofline
share is given: a collective's kernel time holds its waits for the slowest
rank, and NVLink SHARP can beat the nominal ring bandwidth."""

from __future__ import annotations

from benchmark.lib import readings


def _split(record: dict):
    """(NCCL kernels, every other device event) of the device-only trace, as
    (start µs, end µs), with the number of traced steps; None without NCCL."""
    t = readings.traced(record, "train")
    if t is None:
        return None
    nccl, other = [], []
    for name, _, kind, ts, dur in t["summary"]["device"]:
        (nccl if kind == "kernel" and "nccl" in name.lower() else other).append((ts, ts + dur))
    return (nccl, other, t["calls"]) if nccl else None


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def allreduce_ms_per_step(record: dict):
    """Device time of NCCL's kernels a traced step, ms."""
    found = _split(record)
    if found is None:
        return None
    nccl, _, calls = found
    return sum(e - s for s, e in nccl) / 1e3 / calls


def allreduce_exposed_ms_per_step(record: dict):
    """The part of NCCL's kernel time (their union) in which no other kernel,
    memcpy or memset runs on the card, a traced step, ms."""
    found = _split(record)
    if found is None:
        return None
    nccl, other, calls = found
    busy = _union(other)
    exposed = 0.0
    for s, e in _union(nccl):
        covered = sum(max(0.0, min(e, b) - max(s, a)) for a, b in busy if a < e and b > s)
        exposed += (e - s) - covered
    return exposed / 1e3 / calls
