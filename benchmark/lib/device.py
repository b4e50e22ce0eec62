"""The card a run uses: its name and power limit, its published peaks, and
the ``device`` object of the result line."""

from __future__ import annotations

import subprocess

# NVIDIA's data sheet, H100 SXM5, dense rates without sparsity, at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or why
    it could not be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else f"nvidia-smi rc {out.returncode}"


def describe(torch, count: int, memory_peak_bytes: int, smi: str) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes), "nvidia_smi": smi}
