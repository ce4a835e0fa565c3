"""Camera models (port of okvis_tpu.cameras)."""

from .distortion import NUM_DIST_PARAMS, distort, distort_jacobian, undistort  # noqa: F401
from .ncamera import NCameraSystem, make_stereo_rig  # noqa: F401
from .pinhole import (  # noqa: F401
    STATUS_BEHIND,
    STATUS_INVALID,
    STATUS_OK,
    STATUS_OUTSIDE,
    CameraSpec,
    back_project,
    intrinsics_vector,
    project,
    project_homogeneous,
    project_homogeneous_jacobian,
    project_jacobian_intrinsics,
    project_jacobian_point,
)
