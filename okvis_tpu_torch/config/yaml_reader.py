"""OpenCV-YAML config reader (port of okvis_tpu.config.yaml_reader).

The reference's VioParametersReader (okvis_common
VioParametersReader.cpp:76-466): parses the `%YAML:1.0` file format of the
stock EuRoC configuration into the typed VioParameters tree, and builds the
NCameraSystem and the IMU parameters on a device.

PyYAML is imported by read_config alone: a machine without it can still
build VioParameters in code and run everything else.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..cameras.ncamera import NCameraSystem, make_stereo_rig
from ..cameras.pinhole import CameraSpec
from ..device import resolve_device
from ..imu.preintegration import ImuParams
from ..kinematics import SE3, matrix_to_quat
from .parameters import (
    CameraConfig,
    CameraParams,
    ImuConfig,
    OptimizationConfig,
    PoseGraphConfigParams,
    PublishingConfig,
    VioParameters,
)


def _load_opencv_yaml(path: str) -> dict:
    """Load OpenCV-flavored YAML: strip the %YAML:1.0 directive and any
    !!opencv-matrix tags (not used in the EuRoC config, but tolerated)."""
    import yaml

    with open(path) as f:
        text = f.read()
    text = re.sub(r"^%YAML:.*$", "", text, flags=re.MULTILINE)
    text = text.replace("!!opencv-matrix", "")
    return yaml.safe_load(text)


def read_config(path: str) -> VioParameters:
    raw = _load_opencv_yaml(path)
    p = VioParameters()

    for cam in raw.get("cameras", []):
        p.cameras.append(
            CameraConfig(
                T_SC=np.asarray(cam["T_SC"], dtype=np.float64).reshape(4, 4),
                image_dimension=tuple(cam["image_dimension"]),
                distortion_coefficients=list(cam["distortion_coefficients"]),
                distortion_type=str(cam["distortion_type"]),
                focal_length=tuple(cam["focal_length"]),
                principal_point=tuple(cam["principal_point"]),
            )
        )

    cp = raw.get("camera_params", {})
    p.camera_params = CameraParams(
        camera_rate=cp.get("camera_rate", 20.0),
        sigma_absolute_translation=cp.get("sigma_absolute_translation", 0.0),
        sigma_absolute_orientation=cp.get("sigma_absolute_orientation", 0.0),
        sigma_c_relative_translation=cp.get("sigma_c_relative_translation", 0.0),
        sigma_c_relative_orientation=cp.get("sigma_c_relative_orientation", 0.0),
        timestamp_tolerance=cp.get("timestamp_tolerance", 0.005),
    )

    ip = raw.get("imu_params", {})
    p.imu = ImuConfig(
        a_max=ip.get("a_max", 176.0),
        g_max=ip.get("g_max", 7.8),
        sigma_g_c=ip.get("sigma_g_c", 12.0e-4),
        sigma_a_c=ip.get("sigma_a_c", 8.0e-3),
        sigma_bg=ip.get("sigma_bg", 0.03),
        sigma_ba=ip.get("sigma_ba", 0.1),
        sigma_gw_c=ip.get("sigma_gw_c", 4.0e-6),
        sigma_aw_c=ip.get("sigma_aw_c", 4.0e-5),
        tau=ip.get("tau", 3600.0),
        g=ip.get("g", 9.81007),
        a0=tuple(ip.get("a0", (0.0, 0.0, 0.0))),
        imu_rate=ip.get("imu_rate", 200),
        T_BS=np.asarray(ip["T_BS"], dtype=np.float64).reshape(4, 4) if "T_BS" in ip else None,
    )

    co = raw.get("ceres_options", {})
    do = raw.get("detection_options", {})
    dist = raw.get("distributed", {})
    p.optimization = OptimizationConfig(
        num_keyframes=raw.get("numKeyframes", 5),
        num_imu_frames=raw.get("numImuFrames", 3),
        min_iterations=co.get("minIterations", 3),
        max_iterations=co.get("maxIterations", 10),
        time_limit=co.get("timeLimit", 0.035),
        detection_threshold=do.get("threshold", 40.0),
        detection_octaves=do.get("octaves", 0),
        max_num_keypoints=do.get("maxNoKeypoints", 400),
        # the JAX package's extension key (absent from the stock reference
        # YAML): shard the BA over N devices
        distributed_devices=dist.get("devices", 0) if isinstance(dist, dict) else 0,
    )

    pub = raw.get("publishing_options", {})
    p.publishing = PublishingConfig(
        publish_rate=pub.get("publish_rate", 200),
        publish_landmarks=_as_bool(pub.get("publishLandmarks", True)),
        landmark_quality_threshold=pub.get("landmarkQualityThreshold", 1.0e-5),
        publish_imu_propagated_state=_as_bool(pub.get("publishImuPropagatedState", True)),
    )
    # the pose-graph block, the JAX package's extension (the stock reference
    # config has no such section; absent -> disabled)
    pg = raw.get("posegraph", {})
    if pg:
        p.posegraph = PoseGraphConfigParams(
            enabled=_as_bool(pg.get("enabled", True)),
            score_threshold=pg.get("scoreThreshold", 0.22),
            min_gap=pg.get("minGap", 10),
            min_inliers=pg.get("minInliers", 20),
            node_capacity=pg.get("nodeCapacity", 256),
            edge_capacity=pg.get("edgeCapacity", 512),
            cull_redundant=_as_bool(pg.get("cullRedundant", False)),
        )

    p.image_delay = raw.get("imageDelay", 0.0)
    return p


def _as_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() == "true"
    return bool(v)


def build_rig(params: VioParameters, compute_overlaps: bool = True, device=None,
              dtype: torch.dtype = torch.float64) -> NCameraSystem:
    """NCameraSystem from parsed camera configs on `device` (the card unless
    the caller asks for the CPU), in `dtype` (the reference's
    VioParametersReader builds it with computeOverlaps=true,
    VioParametersReader.cpp:310-360)."""
    device = resolve_device(device)

    def t(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    specs, T_SC_list, intr_list = [], [], []
    for cam in params.cameras:
        w, h = cam.image_dimension
        specs.append(CameraSpec(int(w), int(h), cam.dist_type_short))
        T = cam.T_SC
        T_SC_list.append(SE3(r=t(T[:3, 3]), q=matrix_to_quat(t(T[:3, :3]))))
        intr_list.append(t([*cam.focal_length, *cam.principal_point, *cam.distortion_coefficients]))
    return make_stereo_rig(specs, T_SC_list, intr_list, compute_overlaps=compute_overlaps)


def build_imu_params(params: VioParameters, device=None, dtype: torch.dtype = torch.float64) -> ImuParams:
    """ImuParams from the parsed IMU config on `device` (the card unless the
    caller asks for the CPU), in `dtype`."""
    device = resolve_device(device)
    i = params.imu

    def f(v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, np.float64), device=device).to(dtype)

    return ImuParams(
        sigma_g_c=f(i.sigma_g_c),
        sigma_a_c=f(i.sigma_a_c),
        sigma_gw_c=f(i.sigma_gw_c),
        sigma_aw_c=f(i.sigma_aw_c),
        g=f(i.g),
        g_max=f(i.g_max),
        a_max=f(i.a_max),
        sigma_bg=f(i.sigma_bg),
        sigma_ba=f(i.sigma_ba),
        a0=f(i.a0),
        rate=int(i.imu_rate),
    )
