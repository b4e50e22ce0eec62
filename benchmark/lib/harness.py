"""What every driver and the command share: the run's context, loading a
file of the benchmark by name, the precision-independent comparisons, and
the check that the run loaded nothing of JAX."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Callable, Dict, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tcs_tpu")


@dataclasses.dataclass
class Context:
    """One run of one cell. ``program`` builds the system under test from
    (context, state dict); ``None`` is the port, and the control or a test's
    broken program stand in for it."""

    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    program: Optional[Callable] = None
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr, flush=True)


def load_json(relpath: str) -> dict:
    return json.loads((ROOT / relpath).read_text())


def load_module(path: Path):
    """A benchmark file as a module, by its path (names may hold dots)."""
    name = "benchmark_file_" + "_".join(path.relative_to(BENCH).with_suffix("").parts)
    name = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    each name compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """max over leaves of |prog − ref| / max(ref of the leaf, median leaf's
    ref); ``keep`` limits the leaves. A leaf missing from ``prog`` reads 0."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return math.nan
    vals = sorted(ref[n] for n in names)
    med = vals[len(vals) // 2]
    return max(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med) for n in names)


def judged(readings: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """The readings that have a limit, each with it; a reading that is not a
    number fails."""
    return {name: {"value": readings.get(name, math.nan), "limit": spec["limit"]}
            for name, spec in limits.get("checks", {}).items()}


def passes(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(
        isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())


def peak_bytes(torch, device) -> int:
    """The caching allocator's peak on a card; 0 elsewhere."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def release(torch, device) -> None:
    """Free the program's cached blocks before the reference runs."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], keep=None, top: int = 3) -> str:
    """The leaves with the largest gaps (as :func:`worst_leaf_gap` measures
    them), with their two norms, for the log."""
    names = [n for n in ref if keep is None or n in keep]
    vals = sorted(ref[n] for n in names)
    med = vals[len(vals) // 2]
    gaps = sorted(((abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med), n) for n in names),
                  reverse=True)[:top]
    return "; ".join(f"{n} {g:.3g} ({prog.get(n, 0.0):.4g} vs {ref[n]:.4g})" for g, n in gaps)
