"""Typed configuration tree (copy of okvis_tpu.config.parameters; the
reference's okvis::VioParameters, okvis_common Parameters.hpp:60-297).

The defaults are the EuRoC reference configuration's values. The port's
ThreadedVio refuses the fields of modes it does not hold yet (per-state
extrinsics, distributed_devices > 0, an enabled pose graph,
detection_octaves > 0)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CameraConfig:
    T_SC: np.ndarray  # (4, 4)
    image_dimension: Tuple[int, int]  # (width, height)
    distortion_coefficients: List[float]
    distortion_type: str  # radialtangential | radialtangential8 | equidistant | none
    focal_length: Tuple[float, float]
    principal_point: Tuple[float, float]

    @property
    def dist_type_short(self) -> str:
        return {
            "radialtangential": "radtan",
            "radialtangential8": "radtan8",
            "equidistant": "equidistant",
            "none": "none",
        }[self.distortion_type]


@dataclasses.dataclass
class CameraParams:
    """ref ExtrinsicsEstimationParameters + camera system timing
    (Parameters.hpp:60-99)."""

    camera_rate: float = 20.0
    sigma_absolute_translation: float = 0.0
    sigma_absolute_orientation: float = 0.0
    sigma_c_relative_translation: float = 0.0
    sigma_c_relative_orientation: float = 0.0
    timestamp_tolerance: float = 0.005


@dataclasses.dataclass
class ImuConfig:
    """ref ImuParameters (Parameters.hpp:100-133)."""

    a_max: float = 176.0
    g_max: float = 7.8
    sigma_g_c: float = 12.0e-4
    sigma_a_c: float = 8.0e-3
    sigma_bg: float = 0.03
    sigma_ba: float = 0.1
    sigma_gw_c: float = 4.0e-6
    sigma_aw_c: float = 4.0e-5
    tau: float = 3600.0
    g: float = 9.81007
    a0: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    imu_rate: int = 200
    T_BS: Optional[np.ndarray] = None


@dataclasses.dataclass
class OptimizationConfig:
    """ref Optimization struct + ceres_options (Parameters.hpp:167-200)."""

    num_keyframes: int = 5
    num_imu_frames: int = 3
    min_iterations: int = 3
    max_iterations: int = 10
    time_limit: float = 0.035
    detection_threshold: float = 40.0
    detection_octaves: int = 0
    max_num_keypoints: int = 400
    # >0: run the sliding-window BA sharded over this many devices (the JAX
    # package's parallel.sharded_ba; not ported)
    distributed_devices: int = 0


@dataclasses.dataclass
class PoseGraphConfigParams:
    """Pose-graph / loop-closure layer (the JAX package's extension; the
    reference has none; okvis_tpu_torch.posegraph). Off unless the YAML
    enables it."""

    enabled: bool = False
    score_threshold: float = 0.22
    min_gap: int = 10
    min_inliers: int = 20
    node_capacity: int = 256
    edge_capacity: int = 512
    cull_redundant: bool = False


@dataclasses.dataclass
class PublishingConfig:
    publish_rate: int = 200
    publish_landmarks: bool = True
    landmark_quality_threshold: float = 1.0e-5
    publish_imu_propagated_state: bool = True


@dataclasses.dataclass
class VioParameters:
    """Umbrella (ref Parameters.hpp:280-297)."""

    cameras: List[CameraConfig] = dataclasses.field(default_factory=list)
    camera_params: CameraParams = dataclasses.field(default_factory=CameraParams)
    imu: ImuConfig = dataclasses.field(default_factory=ImuConfig)
    optimization: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    publishing: PublishingConfig = dataclasses.field(default_factory=PublishingConfig)
    posegraph: PoseGraphConfigParams = dataclasses.field(
        default_factory=PoseGraphConfigParams)
    image_delay: float = 0.0
