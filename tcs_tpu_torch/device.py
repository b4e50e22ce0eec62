"""Device policy of the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. Without a GPU
and without that request they raise: nothing falls back to the CPU quietly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device needs a GPU to be present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tcs_tpu_torch runs on CUDA by default and no GPU is available;"
            " pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
