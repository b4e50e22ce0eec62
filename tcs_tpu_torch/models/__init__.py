"""TCStereo modules of the port (NCHW inside, NHWC at the public interface)."""

from tcs_tpu_torch.models.tc_stereo import (
    CameraParams,
    TCStereo,
    TCStereoOutput,
    TemporalState,
)

__all__ = ["CameraParams", "TCStereo", "TCStereoOutput", "TemporalState"]
