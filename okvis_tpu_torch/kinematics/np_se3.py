"""Host-side (numpy) SE(3) helpers for bookkeeping code paths (a copy of
okvis_tpu.kinematics.np_se3).

Same conventions as kinematics/se3.py (quaternions xyzw; T_AB = (r, q) with
p_A = C(q) p_B + r). Used where a device round trip would be wasteful, on
single transforms, not batches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Pose = Tuple[np.ndarray, np.ndarray]


def quat_multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    return np.array([-q[0], -q[1], -q[2], q[3]])


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    u, w = q[:3], q[3]
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q)


def compose(r1: np.ndarray, q1: np.ndarray, r2: np.ndarray,
            q2: np.ndarray) -> Pose:
    """T_AC = T_AB * T_BC."""
    return quat_rotate(q1, r2) + r1, quat_normalize(quat_multiply(q1, q2))


def inverse(r: np.ndarray, q: np.ndarray) -> Pose:
    qi = quat_conjugate(q)
    return -quat_rotate(qi, r), qi


def relative(r_wi: np.ndarray, q_wi: np.ndarray, r_wj: np.ndarray,
             q_wj: np.ndarray) -> Pose:
    """T_ij = T_Wi^-1 * T_Wj."""
    ri, qi = inverse(r_wi, q_wi)
    return compose(ri, qi, r_wj, q_wj)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def matrix_to_quat(C: np.ndarray) -> np.ndarray:
    t = np.trace(C)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return quat_normalize(np.array([
            (C[2, 1] - C[1, 2]) / s, (C[0, 2] - C[2, 0]) / s,
            (C[1, 0] - C[0, 1]) / s, 0.25 * s]))
    i = int(np.argmax(np.diag(C)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(C[i, i] - C[j, j] - C[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[3] = (C[k, j] - C[j, k]) / s
    q[j] = (C[j, i] + C[i, j]) / s
    q[k] = (C[k, i] + C[i, k]) / s
    return quat_normalize(q)
