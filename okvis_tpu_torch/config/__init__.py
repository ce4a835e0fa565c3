"""Config system (port of okvis_tpu.config: the reference's okvis_common
parameters and YAML reader)."""

from .parameters import (  # noqa: F401
    CameraConfig,
    CameraParams,
    ImuConfig,
    OptimizationConfig,
    PublishingConfig,
    VioParameters,
)
from .yaml_reader import build_imu_params, build_rig, read_config  # noqa: F401
