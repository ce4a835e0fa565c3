"""Batched SE(3)/quaternion math (port of okvis_tpu.kinematics)."""

from .se3 import (  # noqa: F401
    SE3,
    compose,
    from_matrix,
    identity,
    inverse,
    lift_jacobian,
    minus,
    oplus,
    oplus_jacobian,
    transform_hpoint,
    transform_point,
)
from .so3 import (  # noqa: F401
    cross_matrix,
    delta_q,
    matrix_to_quat,
    quat_conjugate,
    quat_identity,
    quat_inverse,
    quat_left,
    quat_multiply,
    quat_normalize,
    quat_right,
    quat_rotate,
    quat_to_matrix,
    right_jacobian,
    safe_norm,
    sinc,
)
