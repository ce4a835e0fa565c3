"""Vision frontend (port of okvis_tpu.frontend): detection, BRISK description,
stereo matching and triangulation."""

from .brisk import describe_keypoints, detect_and_describe, gravity_extraction_angle  # noqa: F401
from .detection import Keypoints, detect_keypoints, harris_response  # noqa: F401
from .frame import FrameData, MultiFrame  # noqa: F401
from .frontend import Frontend, FrontendConfig  # noqa: F401
from .keyframe import need_new_keyframe  # noqa: F401
from .ransac import (  # noqa: F401
    ransac_absolute_pose,
    ransac_relative_pose,
    ransac_rotation_only,
)
from .triangulation import triangulate_fast  # noqa: F401
