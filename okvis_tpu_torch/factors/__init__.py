"""Factor residuals and Jacobians (port of okvis_tpu.factors), batched."""

from .imu_factor import ImuFactorJacobians, imu_error  # noqa: F401
from .priors import (  # noqa: F401
    homogeneous_point_error,
    pose_error,
    relative_pose_error,
    speed_and_bias_error,
    sqrt_information,
)
from .reprojection import ReprojectionJacobians, reprojection_error  # noqa: F401
