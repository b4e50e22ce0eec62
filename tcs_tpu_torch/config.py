"""Model and training configuration of the PyTorch port.

The port's own copy of the architecture fields of ``tcs_tpu.config.ModelConfig``
(reference ``train_stereo.py:480-487``) and of the recipe, loss and optimiser
fields of ``tcs_tpu.config.TrainConfig``. The TPU layout knobs of the JAX
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training recipe (the flag sets of the reference's three .sh scripts).

    The JAX package's ``TrainConfig`` also carries the formulation of its
    backward (differentiated frame scan, frame-parallel or frame-inline,
    hoisted encoder and losses, remat policies, scan unrolling). Those are XLA
    scheduling choices that its tests pin as numerically equivalent. The port
    has one formulation, the frame-inline one: a Python loop over the frames
    with one ``backward()`` per frame, which frees that frame's graph. So none
    of those fields is carried over. The run name and the augmentation,
    checkpoint and loader fields come with the trainer and the data readers.
    """

    train_dataset: str = "sceneflow"  # {'sceneflow','TartanAir','kitti_raw'}
    lr: float = 2e-4
    num_steps: int = 200_000
    batch_size: int = 4  # per-process batch (reference: per-GPU batch 4)
    image_size: Tuple[int, int] = (320, 720)  # (H, W) crop
    frame_length: int = 2  # frames per window; carries are detached between them
    # For the data readers (a later slice): False makes them yield single
    # pairs. The train step takes the window it is given, whatever this says.
    temporal: bool = True
    train_iters: int = 5
    wdecay: float = 1e-5
    grad_clip: float = 1.0
    seed: int = 1234
    # Loss weights (reference ``train_stereo.py:364-398``)
    loss_gamma: float = 0.9
    normal_loss_weight: float = 0.25
    grad_loss_weight: float = 5.0
    init_k: int = 3
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)


def sceneflow_recipe() -> TrainConfig:
    """``sceneflow_ddp_train.sh``: 200k steps, b4, lr 2e-4, 320x720, fl 2."""
    return TrainConfig(train_dataset="sceneflow",
                       lr=2e-4, num_steps=200_000, batch_size=4,
                       image_size=(320, 720), frame_length=2)


def tartanair_recipe() -> TrainConfig:
    """``tartanair_ddp_train.sh``: 100k steps, b4, lr 2e-4, 480x640, fl 4."""
    return TrainConfig(train_dataset="TartanAir",
                       lr=2e-4, num_steps=100_000, batch_size=4,
                       image_size=(480, 640), frame_length=4)


def kitti_raw_recipe() -> TrainConfig:
    """``KITTI_ddp_train.sh``: 60k steps, b4, lr 1e-4, 320x1024, fl 4."""
    return TrainConfig(train_dataset="kitti_raw", lr=1e-4,
                       num_steps=60_000, batch_size=4, image_size=(320, 1024),
                       frame_length=4)

