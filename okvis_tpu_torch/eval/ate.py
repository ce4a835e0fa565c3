"""Trajectory evaluation: ATE RMSE with Umeyama SE(3)/Sim(3) alignment (a copy
of okvis_tpu.eval.ate).

The EuRoC protocol: associate estimate and ground truth by timestamp,
SE(3)-align (the yaw + position gauge freedom of VIO), RMSE over position
errors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def associate(
    ts_a: np.ndarray, ts_b: np.ndarray, max_dt_ns: int = 20_000_000
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association (indices into a and b)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        while j + 1 < len(ts_b) and abs(int(ts_b[j + 1]) - int(t)) <= abs(
            int(ts_b[j]) - int(t)
        ):
            j += 1
        if abs(int(ts_b[j]) - int(t)) <= max_dt_ns:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform: dst ≈ s R src + t.

    Returns (R, t, s)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(S) @ D) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    est_ts: np.ndarray,
    est_pos: np.ndarray,
    gt_ts: np.ndarray,
    gt_pos: np.ndarray,
    with_scale: bool = False,
    max_dt_ns: int = 20_000_000,
) -> Optional[float]:
    """Absolute trajectory error RMSE [m] after alignment; None if too few
    associations."""
    ia, ib = associate(est_ts, gt_ts, max_dt_ns)
    if len(ia) < 3:
        return None
    e = est_pos[ia]
    g = gt_pos[ib]
    R, t, s = umeyama_alignment(e, g, with_scale)
    aligned = (s * (R @ e.T)).T + t
    err = aligned - g
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def write_tum(path: str, ts_ns: np.ndarray, pos: np.ndarray, quat_xyzw: np.ndarray):
    """TUM trajectory format for external evaluators (SURVEY.md §5.5)."""
    with open(path, "w") as f:
        for t, p, q in zip(ts_ns, pos, quat_xyzw):
            f.write(
                f"{int(t)/1e9:.9f} {p[0]} {p[1]} {p[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n"
            )
