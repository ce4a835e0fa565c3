"""Write a VioParameters tree as the OpenCV YAML that read_config reads (the
`%YAML:1.0` layout of the stock EuRoC configuration, with the JAX package's
`distributed` and `posegraph` extension blocks), and describe a rig's
cameras as CameraConfig entries.

Plain string formatting, no PyYAML. Floats are written as Python's repr,
with a decimal point in every exponent form (PyYAML reads "1e-05" as a
string), so read_config of either package gives the tree back exactly.
"""

from __future__ import annotations

import numpy as np

from ..kinematics import np_se3
from .parameters import CameraConfig, VioParameters

DIST_TYPES = {"radtan": "radialtangential", "radtan8": "radialtangential8", "equidistant": "equidistant",
              "none": "none"}


def _num(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    s = repr(float(v))
    if "e" in s and "." not in s.split("e")[0]:
        m, e = s.split("e")
        s = f"{m}.0e{e}"
    return s


def _list(vals) -> str:
    return "[" + ", ".join(_num(v) for v in np.asarray(vals, dtype=object).ravel()) + "]"


def cameras_from_rig(rig) -> list:
    """The CameraConfig of each camera of an NCameraSystem (any device):
    T_SC as a 4 x 4 matrix, the pinhole and distortion parameters."""
    out = []
    for c, spec in enumerate(rig.specs):
        intr = rig.intrinsics[c].detach().cpu().double().numpy()
        T = np.eye(4)
        T[:3, :3] = np_se3.quat_to_matrix(rig.T_SC.q[c].detach().cpu().double().numpy())
        T[:3, 3] = rig.T_SC.r[c].detach().cpu().double().numpy()
        out.append(CameraConfig(T_SC=T, image_dimension=(spec.width, spec.height),
                                distortion_coefficients=[float(x) for x in intr[4:]],
                                distortion_type=DIST_TYPES[spec.dist_type],
                                focal_length=(float(intr[0]), float(intr[1])),
                                principal_point=(float(intr[2]), float(intr[3]))))
    return out


def write_config(p: VioParameters, path: str) -> None:
    """Write `p` to `path` as OpenCV YAML."""
    lines = ["%YAML:1.0", "cameras:"]
    for cam in p.cameras:
        lines.append(
            f"     - {{T_SC: {_list(cam.T_SC)}, image_dimension: {_list(cam.image_dimension)}, "
            f"distortion_coefficients: {_list(cam.distortion_coefficients)}, "
            f"distortion_type: {cam.distortion_type}, focal_length: {_list(cam.focal_length)}, "
            f"principal_point: {_list(cam.principal_point)}}}")
    cp, imu, opt, pub, pg = p.camera_params, p.imu, p.optimization, p.publishing, p.posegraph
    blocks = [
        ("camera_params", dict(camera_rate=cp.camera_rate, sigma_absolute_translation=cp.sigma_absolute_translation,
                               sigma_absolute_orientation=cp.sigma_absolute_orientation,
                               sigma_c_relative_translation=cp.sigma_c_relative_translation,
                               sigma_c_relative_orientation=cp.sigma_c_relative_orientation,
                               timestamp_tolerance=cp.timestamp_tolerance)),
        ("imu_params", dict(a_max=imu.a_max, g_max=imu.g_max, sigma_g_c=imu.sigma_g_c, sigma_a_c=imu.sigma_a_c,
                            sigma_bg=imu.sigma_bg, sigma_ba=imu.sigma_ba, sigma_gw_c=imu.sigma_gw_c,
                            sigma_aw_c=imu.sigma_aw_c, tau=imu.tau, g=imu.g, a0=list(imu.a0),
                            imu_rate=imu.imu_rate, **({} if imu.T_BS is None else dict(T_BS=imu.T_BS)))),
        ("numKeyframes", opt.num_keyframes),
        ("numImuFrames", opt.num_imu_frames),
        ("ceres_options", dict(minIterations=opt.min_iterations, maxIterations=opt.max_iterations,
                               timeLimit=opt.time_limit)),
        ("detection_options", dict(threshold=opt.detection_threshold, octaves=opt.detection_octaves,
                                   maxNoKeypoints=opt.max_num_keypoints)),
        ("publishing_options", dict(publish_rate=pub.publish_rate, publishLandmarks=pub.publish_landmarks,
                                    landmarkQualityThreshold=pub.landmark_quality_threshold,
                                    publishImuPropagatedState=pub.publish_imu_propagated_state)),
        ("distributed", dict(devices=opt.distributed_devices)),
        ("posegraph", dict(enabled=pg.enabled, scoreThreshold=pg.score_threshold, minGap=pg.min_gap,
                           minInliers=pg.min_inliers, nodeCapacity=pg.node_capacity,
                           edgeCapacity=pg.edge_capacity, cullRedundant=pg.cull_redundant)),
        ("imageDelay", p.image_delay),
    ]
    for key, val in blocks:
        if not isinstance(val, dict):
            lines.append(f"{key}: {_num(val)}")
            continue
        lines.append(f"{key}:")
        for k, v in val.items():
            text = _list(v) if isinstance(v, (list, tuple, np.ndarray)) else _num(v)
            lines.append(f"    {k}: {text}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
