"""Synthetic VIO world: analytic trajectory + IMU, landmark cloud, rendered
camera images, and the bundle-adjustment window built from them (port of
okvis_tpu.datasets.synthetic).

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
from ..factors.priors import sqrt_information
from ..imu.preintegration import ImuParams, preintegrate
from ..solver.structure import WindowConfig, empty_problem


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


def build_ba_problem(
    num_frames: int = 4,
    frame_stride: int = 60,  # IMU samples between frames (0.3 s at 200 Hz)
    n_landmarks: int = 96,
    pixel_noise: float = 0.7,
    duration: float = 4.0,
    seed: int = 5,
    cfg_kwargs: Optional[dict] = None,
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """A fully populated BaProblem of the synthetic world, on `device` in
    `dtype` (the JAX package's build_ba_problem, draw for draw).

    Returns (cfg, imu_params, intrinsics, problem_at_truth, truth). The truth
    stays float64 numpy. The observations are projected in float64 on the
    host, so every device and dtype sees the same observation table; the IMU
    links preintegrate in one batched call on `device`, with each link's
    timestamps rebased to its first sample before the cast to `dtype`."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    traj = simulate_trajectory(duration=duration, seed=seed)
    specs, T_SC, intrinsics64 = euroc_stereo_rig(device="cpu")
    lms = make_landmarks(traj, n_landmarks, seed=seed + 1)
    imu_params = ImuParams.euroc(dtype=dtype, device=device)

    frame_idx = [i * frame_stride for i in range(num_frames)]
    S = num_frames
    cfg_defaults = dict(
        num_states=S,
        num_cameras=2,
        max_landmarks=max(128, n_landmarks),
        max_observations=2048,
        imu_samples=frame_stride + 2,
        max_imu_links=max(S - 1, 1),
        camera_specs=specs,
    )
    cfg_defaults.update(cfg_kwargs or {})
    cfg = WindowConfig(**cfg_defaults)
    problem = empty_problem(cfg, dtype=dtype, device=device)

    def t(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64)).to(device=device, dtype=dtype)

    def i32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32)).to(device)

    # ground-truth states
    sb = np.concatenate([traj.v[frame_idx], np.zeros((S, 6))], axis=1)
    st = problem.states
    st.r_WS[:S] = t(traj.r[frame_idx])
    st.q_WS[:S] = t(traj.q[frame_idx])
    st.speed_and_bias[:S] = t(sb)
    st.r_SC[:] = T_SC.r.to(device=device, dtype=dtype)
    st.q_SC[:] = T_SC.q.to(device=device, dtype=dtype)
    st.hp_W[:n_landmarks, :3] = t(lms)
    problem.state_mask[:S] = True
    problem.lm_mask[:n_landmarks] = True

    # observations: project every landmark into every frame and camera
    lms_cpu = torch.from_numpy(lms)
    rows = []  # (state, camera, landmark slots, noisy keypoints)
    for si, fi in enumerate(frame_idx):
        T_WS_i = kin.SE3(r=torch.from_numpy(traj.r[fi]), q=torch.from_numpy(traj.q[fi]))
        for c in range(2):
            T_CW = kin.inverse(kin.compose(T_WS_i, kin.SE3(r=T_SC.r[c], q=T_SC.q[c])))
            uv, flags = pinhole.project(specs[c], intrinsics64[c], kin.transform_point(T_CW, lms_cpu))
            ok = np.nonzero(flags.numpy() == pinhole.STATUS_OK)[0]
            rows.append((si, c, ok, uv.numpy()[ok] + rng.normal(0, pixel_noise, (len(ok), 2))))
    O = sum(len(r[2]) for r in rows)
    if O > cfg.max_observations:
        raise ValueError(f"{O} observations exceed the capacity {cfg.max_observations}")
    obs = problem.obs
    obs.state_idx[:O] = i32(np.concatenate([np.full(len(r[2]), r[0]) for r in rows]))
    obs.cam_idx[:O] = i32(np.concatenate([np.full(len(r[2]), r[1]) for r in rows]))
    obs.lm_idx[:O] = i32(np.concatenate([r[2] for r in rows]))
    obs.keypoint[:O] = t(np.concatenate([r[3] for r in rows]))
    obs.sqrt_info[:O] = 1.0 / pixel_noise
    obs.mask[:O] = True

    # IMU links between consecutive frames, preintegrated in one call
    P, K = cfg.imu_samples, S - 1
    ts, gy, ac, t0, t1 = [], [], [], [], []
    for k in range(K):
        a, b = frame_idx[k], frame_idx[k + 1]
        sl = slice(a, min(a + P, len(traj.ts)))
        n = sl.stop - sl.start
        ts_k = np.full(P, traj.ts[sl][-1])
        gy_k = np.tile(traj.gyro[sl][-1], (P, 1))
        ac_k = np.tile(traj.acc[sl][-1], (P, 1))
        ts_k[:n], gy_k[:n], ac_k[:n] = traj.ts[sl], traj.gyro[sl], traj.acc[sl]
        origin = ts_k[0]
        ts.append(ts_k - origin)
        gy.append(gy_k)
        ac.append(ac_k)
        t0.append(traj.ts[a] - origin)
        t1.append(traj.ts[b] - origin)
    # preintegrate's arguments, in its order
    links = dict(timestamps=np.asarray(ts), gyro=np.asarray(gy), acc=np.asarray(ac),
                 t0=np.asarray(t0), t1=np.asarray(t1), sb_ref=sb[:K])
    if K > 0:
        pre = preintegrate(imu_params, *(t(v) for v in links.values()))
        for full, part in zip(problem.imu_links.pre, pre):
            full[:K] = part
        problem.imu_links.idx_a[:K] = i32(np.arange(K))
        problem.imu_links.idx_b[:K] = i32(np.arange(1, K + 1))
        problem.imu_links.mask[:K] = True

    # priors on the first state
    pp, sp = problem.pose_priors, problem.sb_priors
    pp.r_meas[0] = st.r_WS[0]
    pp.q_meas[0] = st.q_WS[0]
    pp.sqrt_info[0] = t(sqrt_information(torch.eye(6, dtype=torch.float64) * 1e8))
    pp.mask[0] = True
    sp.sb_meas[0] = st.speed_and_bias[0]
    sp.sqrt_info[0] = t(sqrt_information(torch.diag(torch.tensor([1e4] * 3 + [1e2] * 6,
                                                                  dtype=torch.float64))))
    sp.mask[0] = True

    truth = {
        "r_WS": traj.r[frame_idx],
        "q_WS": traj.q[frame_idx],
        "sb": sb,
        "landmarks": lms,
        "n_landmarks": n_landmarks,
        "num_obs": O,
        "frame_idx": frame_idx,
        "traj": traj,
        "imu_links": links,  # each link's preintegrate inputs, rebased timestamps
    }
    return cfg, imu_params, [i.to(device=device, dtype=dtype) for i in intrinsics64], problem, truth


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
