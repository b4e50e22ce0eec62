"""tcs_tpu_torch: the PyTorch/CUDA port of tcs_tpu for NVIDIA Hopper (H100).

Streaming temporal TCStereo inference with hand-written CUDA kernels for the
correlation-pyramid lookup and the softmax splat. The package imports
``torch`` and ``numpy`` only; the JAX package beside it is its reference.
"""

from tcs_tpu_torch.config import ModelConfig

__all__ = ["ModelConfig"]
