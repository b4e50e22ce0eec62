"""Device policy of the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. Without a GPU
and without that request they raise: nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms inside the block, and no autotuning;
    both switches are put back on the way out, an exception's too.

    By default cuDNN may pick convolution algorithms whose sums are ordered
    differently from call to call: on the card the fp32 config's step then
    parts in the first loss between two runs from one state, and a stopped
    run that resumes need not retrace the uninterrupted one. Inside this
    block it does, bit for bit. The CPU's step is deterministic without it.
    """
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
