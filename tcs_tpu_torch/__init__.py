"""tcs_tpu_torch: the PyTorch/CUDA port of tcs_tpu for NVIDIA Hopper (H100).

Streaming temporal TCStereo inference, the frame-window training step,
training from files on disk (datasets, augmentation, a loader of worker
processes, the trainer with full checkpoints and resume, and its CLI) and
the three temporal evaluators with their data readers, for every
architecture variant of the reference, with hand-written CUDA kernels for
the correlation-pyramid lookup and the softmax splat and for their backward
passes, and a host core in plain C for the data path. The package imports
``torch`` and ``numpy`` only; the JAX package beside it is its reference.
"""

from tcs_tpu_torch.config import ModelConfig, TrainConfig

__all__ = ["ModelConfig", "TrainConfig"]
