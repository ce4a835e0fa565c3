"""The estimate against the rendered truth: ATE after an SE(3) Umeyama
alignment (a copy of okvis_tpu_torch/eval/ate.py's arithmetic, the EuRoC
protocol), and the orientation error after aligning the one rotation that
visual-inertial odometry cannot observe, the yaw about gravity."""

from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray) -> tuple:
    """(R, t) minimising |dst - (R src + t)|^2."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U) * np.linalg.det(Vt))])
    R = U @ D @ Vt
    return R, mu_d - R @ mu_s


def ate(est_pos: np.ndarray, true_pos: np.ndarray) -> float:
    """RMS position error (m) after the SE(3) alignment of the estimate onto
    the truth (same stamps, row for row)."""
    R, t = umeyama(est_pos, true_pos)
    err = est_pos @ R.T + t - true_pos
    return float(np.sqrt((err ** 2).sum(1).mean()))


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(N, 4) unit quaternions (x, y, z, w), Hamilton -> (N, 3, 3)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)


def rotation_angle(R: np.ndarray) -> np.ndarray:
    """(N, 3, 3) -> (N,) angles in radians."""
    return np.arccos(np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0))


def orientation_error_deg(est_R: np.ndarray, true_R: np.ndarray) -> float:
    """RMS angle (degrees) between the estimated and true orientations after
    turning the estimate about the world's z (gravity) axis by the yaw that
    best fits all of them: R_z maximising trace(R_z sum est_i true_i^T)
    (same stamps, row for row)."""
    M = (true_R @ np.swapaxes(est_R, -1, -2)).sum(0)  # sum true_i est_i^T
    yaw = np.arctan2(M[1, 0] - M[0, 1], M[0, 0] + M[1, 1])
    c, s = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    err = rotation_angle(np.swapaxes(true_R, -1, -2) @ (Rz @ est_R))
    return float(np.degrees(np.sqrt((err ** 2).mean())))
