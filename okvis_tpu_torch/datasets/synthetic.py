"""Synthetic VIO world: analytic trajectory + IMU, landmark cloud, rendered
camera images (port of the vision subset of okvis_tpu.datasets.synthetic).

The trajectory, IMU and landmarks are numpy, made from a seed; the rig and
the projection used by the renderer are the port's own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import kinematics as kin
from ..cameras import pinhole
from ..cameras.pinhole import CameraSpec
from ..device import resolve_device


def _np_quat_mul(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def _np_delta_q(da):
    half = 0.5 * np.linalg.norm(da)
    s = np.sinc(half / np.pi)
    return np.array([*(s * 0.5 * da), np.cos(half)])


def _np_quat_to_matrix(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


@dataclasses.dataclass
class SyntheticImu:
    """IMU samples + ground-truth states at each sample time."""

    ts: np.ndarray  # (N,) seconds
    gyro: np.ndarray  # (N, 3)
    acc: np.ndarray  # (N, 3)
    r: np.ndarray  # (N, 3) ground-truth position
    q: np.ndarray  # (N, 4) ground-truth orientation (xyzw)
    v: np.ndarray  # (N, 3) ground-truth velocity
    g: float


def simulate_trajectory(
    duration: float = 2.0,
    imu_rate: int = 200,
    fine_substeps: int = 50,
    seed: int = 1,
    motion_scale: float = 1.0,
    g: float = 9.81007,
    omega_fn: Optional[Callable] = None,
    acc_w_fn: Optional[Callable] = None,
) -> SyntheticImu:
    """Integrate a smooth sinusoidal trajectory; emit exact IMU measurements
    (ground truth from fine midpoint integration, fine_substeps per IMU
    interval)."""
    rng = np.random.default_rng(seed)
    wm = motion_scale * rng.uniform(0.3, 0.9, 3)
    am = motion_scale * rng.uniform(0.5, 1.5, 3)
    ph = rng.uniform(0, 2 * np.pi, 6)

    omega_fn = omega_fn or (
        lambda t: np.array(
            [
                wm[0] * np.sin(1.1 * t + ph[0]),
                wm[1] * np.cos(0.9 * t + ph[1]),
                wm[2] * np.sin(0.7 * t + ph[2]),
            ]
        )
    )
    acc_w_fn = acc_w_fn or (
        lambda t: np.array(
            [
                am[0] * np.sin(1.6 * t + ph[3]),
                am[1] * np.cos(1.2 * t + ph[4]),
                am[2] * np.sin(0.8 * t + ph[5]),
            ]
        )
    )

    n = int(round(duration * imu_rate))
    dt_s = 1.0 / imu_rate
    dt_f = dt_s / fine_substeps
    q = np.array([0.0, 0.0, 0.0, 1.0])
    r = np.zeros(3)
    v = np.zeros(3)
    ts, gy, ac, rs, qs, vs = [], [], [], [], [], []
    for i in range(n + 1):
        t = i * dt_s
        C_WS = _np_quat_to_matrix(q)
        ts.append(t)
        gy.append(omega_fn(t))
        ac.append(C_WS.T @ (acc_w_fn(t) + np.array([0.0, 0.0, g])))
        rs.append(r.copy())
        qs.append(q.copy())
        vs.append(v.copy())
        if i == n:
            break
        for k in range(fine_substeps):
            tm = t + (k + 0.5) * dt_f
            q = _np_quat_mul(q, _np_delta_q(omega_fn(tm) * dt_f))
            q /= np.linalg.norm(q)
            a = acc_w_fn(tm)
            r = r + v * dt_f + 0.5 * a * dt_f * dt_f
            v = v + a * dt_f
    return SyntheticImu(
        ts=np.asarray(ts),
        gyro=np.asarray(gy),
        acc=np.asarray(ac),
        r=np.asarray(rs),
        q=np.asarray(qs),
        v=np.asarray(vs),
        g=g,
    )


def euroc_stereo_rig(device=None, dtype=torch.float64
                     ) -> Tuple[Tuple[CameraSpec, CameraSpec], kin.SE3, list]:
    """EuRoC-like stereo rig: 2 x 752x480, radtan distortion, 11 cm baseline.
    Returns (specs, batched T_SC, [intrinsics per camera])."""
    device = resolve_device(device)
    spec = CameraSpec(752, 480, "radtan")
    intr = torch.tensor([461.4, 460.2, 363.0, 248.1, -0.28, 0.07, 2.0e-4, 1.8e-5],
                        dtype=dtype, device=device)
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    T_SC = kin.SE3(
        r=torch.stack([t([-0.016, -0.064, 0.0098]), t([-0.015, 0.046, 0.0074])]),
        q=kin.quat_normalize(torch.stack([t([0.007, 0.002, -0.002, 1.0]),
                                          t([-0.003, 0.003, 0.002, 1.0])])),
    )
    return (spec, spec), T_SC, [intr, intr.clone()]


def make_landmarks(
    traj: SyntheticImu, n_landmarks: int, seed: int = 2, radius=(2.0, 8.0)
) -> np.ndarray:
    """Landmark cloud in a shell around the trajectory's bounding region."""
    rng = np.random.default_rng(seed)
    center = traj.r.mean(axis=0)
    dirs = rng.normal(size=(n_landmarks, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rad = rng.uniform(radius[0], radius[1], (n_landmarks, 1))
    return center + dirs * rad


def render_world_image(
    spec: CameraSpec,
    intrinsics: torch.Tensor,
    T_WC: kin.SE3,
    landmark_pts: np.ndarray,
    rng_seed: int = 77,
    patch: int = 11,
    background: float = 120.0,
    noise: float = 1.0,
) -> np.ndarray:
    """Render a synthetic (H, W) float32 camera image: each 3D landmark is
    stamped as a fixed random-texture patch at its projection (no occlusion).
    Projection runs in the dtype and on the device of `intrinsics`."""
    H, W = spec.height, spec.width
    rng = np.random.default_rng(rng_seed)
    # per-landmark texture, fixed across frames (deterministic from the seed)
    textures = rng.uniform(-70.0, 70.0, (len(landmark_pts), patch, patch))
    # sharpen: blocky 3x3 super-pixels give strong Harris corners
    for t in textures:
        t[:] = np.kron(
            rng.uniform(-70, 70, (patch // 3 + 1, patch // 3 + 1)),
            np.ones((3, 3)),
        )[:patch, :patch]

    img = np.full((H, W), background, np.float32)
    yy = np.linspace(0, 10, H)[:, None]
    xx = np.linspace(0, 7, W)[None, :]
    img += (yy + xx).astype(np.float32)  # mild gradient
    img += rng.normal(0, noise, (H, W)).astype(np.float32)

    pts = torch.as_tensor(landmark_pts, dtype=intrinsics.dtype, device=intrinsics.device)
    p_C = kin.transform_point(kin.inverse(T_WC), pts)
    uv, flags = pinhole.project(spec, intrinsics, p_C)
    uv = uv.cpu().numpy()
    ok = flags.cpu().numpy() == pinhole.STATUS_OK
    half = patch // 2
    for li in np.nonzero(ok)[0]:
        x, y = int(round(uv[li, 0])), int(round(uv[li, 1]))
        if not (half <= x < W - half and half <= y < H - half):
            continue
        img[y - half : y + half + 1, x - half : x + half + 1] += textures[li]
    return np.clip(img, 0, 255)
