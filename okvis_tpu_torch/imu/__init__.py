"""IMU preintegration and propagation (port of okvis_tpu.imu)."""

from .preintegration import (  # noqa: F401
    ImuParams,
    PreintegratedImu,
    gravity_vector,
    init_pose_from_imu,
    preintegrate,
    propagate,
)
