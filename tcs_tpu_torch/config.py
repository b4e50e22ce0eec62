"""Model configuration of the PyTorch port.

The port's own copy of the architecture fields of ``tcs_tpu.config.ModelConfig``
(reference ``train_stereo.py:480-487``). The TPU layout knobs of the JAX
package (scan unrolling, packed encoders, lookup/splat backend choices, remat,
space-to-depth stems, corr padding) change no numerics and have no meaning on
the GPU, so they are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters."""

    hidden_dims: Tuple[int, ...] = (128, 128, 128)
    context_dims: Tuple[int, ...] = (128, 128, 128)
    corr_levels: int = 4
    corr_radius: int = 4
    n_downsample: int = 2  # disparity field lives at 1/2**n_downsample resolution
    n_gru_layers: int = 3
    context_norm: str = "none"  # only 'none' is ported so far
    shared_backbone: bool = True  # only the shared backbone is ported so far
    slow_fast_gru: bool = False  # no launch script enables it; not ported yet
    mixed_precision: bool = True  # bf16 conv stacks, fp32 correlation/geometry
    # Threshold of the cost-volume contrastive loss (``--init_thres``).
    init_thres: float = 0.5
    # Margin of the sparse argmax bootstrap: the reference hard-codes 0.3 in
    # ``core/corr.py:73`` even though ``--init_thres`` reaches the CorrBlock.
    argmax_margin: float = 0.3
    # Max candidate disparity band suppressed around the main peak (px).
    argmax_suppress_radius: float = 1.5
    # Storage dtype of the lookup pyramid only; the lookup lerps in fp32.
    corr_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.n_gru_layers != 3:
            # The reference's DisparityCompletor consumes context_list[0..2]
            # unconditionally (reference core/update.py:379-396), so no other
            # value runs there either.
            raise ValueError(
                f"n_gru_layers={self.n_gru_layers}: the TC-Stereo"
                " architecture requires exactly 3 GRU/context scales")
        if self.context_norm != "none" or not self.shared_backbone \
                or self.slow_fast_gru:
            raise NotImplementedError(
                "the PyTorch port covers context_norm='none' with the shared"
                " backbone and slow_fast_gru=False")

    @property
    def scale_rate(self) -> float:
        return 1.0 / (2 ** self.n_downsample)

    @property
    def downsample_factor(self) -> int:
        return 2 ** self.n_downsample

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1)
