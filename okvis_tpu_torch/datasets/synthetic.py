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


@dataclasses.dataclass
class EstimatorFrame:
    """One frame of a synthetic estimator run: what a frontend would hand
    the Estimator (numpy only)."""

    frame_id: int
    t: float  # seconds
    imu: Tuple[np.ndarray, np.ndarray, np.ndarray]  # (ts, gyro, acc) slice
    keyframe: bool
    # (landmark id, camera, noisy keypoint (2,), keypoint index) of every
    # camera that sees the landmark, grouped by landmark
    observations: list
    r_WS: np.ndarray  # ground truth
    q_WS: np.ndarray


def estimator_scenario(
    traj: SyntheticImu,
    landmarks: np.ndarray,
    rig,
    n_frames: int,
    seed: int,
    frame_dt: float = 0.1,
    imu_rate: int = 200,
    pixel_noise: float = 0.6,
    init_noise: float = 0.05,
    keep: float = 1.0,
    lm_id0: int = 10_000,
):
    """The synthetic frontend of the JAX package's estimator tests
    (tests/test_estimator.py): frame i at t = i * frame_dt with the IMU
    samples from 24 before to 5 after it, every second frame a keyframe,
    each landmark projected into every camera at the true pose (the rig's
    projection on the CPU in float64) and observed with pixel noise.

    Returns (frames, init): `init` maps a landmark id to its noisy initial
    position, drawn once, at its first stereo sighting. After the first
    frame each visible landmark is kept with probability `keep` (the rest
    model a frontend's missed matches, so landmarks leave the window). Frame
    ids are 1, 2, ...: pass them to add_states so two estimators agree."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(np.asarray(landmarks, np.float64))
    T_SC = kin.SE3(r=rig.T_SC.r.detach().cpu().double(), q=rig.T_SC.q.detach().cpu().double())
    intr = [i.detach().cpu().double() for i in rig.intrinsics]
    frames, init = [], {}
    for fi in range(n_frames):
        t = fi * frame_dt
        idx = int(round(t * imu_rate))
        lo, hi = max(0, idx - 24), min(len(traj.ts), idx + 5)
        T_WS = kin.SE3(r=torch.from_numpy(traj.r[idx]), q=torch.from_numpy(traj.q[idx]))
        uv, ok = [], []
        for c in range(len(rig.specs)):
            T_CW = kin.inverse(kin.compose(T_WS, kin.SE3(r=T_SC.r[c], q=T_SC.q[c])))
            u, flags = pinhole.project(rig.specs[c], intr[c], kin.transform_point(T_CW, pts))
            uv.append(u.numpy())
            ok.append(flags.numpy() == pinhole.STATUS_OK)
        obs = []
        for li in range(len(landmarks)):
            vis = [c for c in range(len(rig.specs)) if ok[c][li]]
            if not vis or (fi and rng.uniform() > keep):
                continue
            lm_id = lm_id0 + li
            if lm_id not in init and len(vis) >= 2:
                init[lm_id] = landmarks[li] + rng.normal(0, init_noise, 3)
            obs.append([(lm_id, c, uv[c][li] + rng.normal(0, pixel_noise, 2), li) for c in vis])
        frames.append(EstimatorFrame(
            frame_id=fi + 1, t=t, imu=(traj.ts[lo:hi], traj.gyro[lo:hi], traj.acc[lo:hi]),
            keyframe=fi % 2 == 0, observations=obs, r_WS=traj.r[idx], q_WS=traj.q[idx]))
    return frames, init


def feed_estimator_frame(est, frame: EstimatorFrame, init: dict) -> int:
    """add_states for the frame, then its landmarks and observations, as the
    estimator tests' frontend does: a landmark is added at its first stereo
    sighting (or again after the estimator removed it), never while the
    landmark table is full; an estimator of either package. Returns the new
    state's id."""
    sid = est.add_states(frame.t, *frame.imu, as_keyframe=frame.keyframe, frame_id=frame.frame_id)
    for group in frame.observations:
        lm_id = group[0][0]
        if not est.is_landmark_added(lm_id):
            if len(group) < 2 or lm_id not in init or not est._free_lm_slots:
                continue
            est.add_landmark(lm_id, init[lm_id])
        for _lm, c, uv, li in group:
            est.add_observation(lm_id, sid, c, uv, keypoint_idx=li, size=8.0)
    return sid


# ---------------------------------------------------------------------------
# the per-frame VIO loop's inputs: IMU slices as a runtime cuts them, and
# keypoint frames of projected landmarks
# ---------------------------------------------------------------------------

IMU_OVERLAP = 0.02  # s of IMU slice overlap on either side (ThreadedKFVio.cpp:52-53)
IMU_LEAD = 0.025  # s of IMU fed past a frame before it is processed


def vio_imu_slice(traj: SyntheticImu, t0: float, t1: float, t_fed: float):
    """(ts, gyro, acc) covering [t0 - 0.02 s, t1 + 0.02 s] from the samples
    fed so far (ts <= t_fed), with one sample before the start, as the
    runtime's IMU buffer slices them (ThreadedKFVio::getImuMeasurments)."""
    ns = lambda t: int(round(t * 1e9))  # noqa: E731  the runtime's integer clock
    ts_ns = np.asarray([ns(t) for t in traj.ts], np.int64)
    fed = ts_ns <= ns(t_fed)
    ts_ns = ts_ns[fed]
    i0 = max(0, int(np.searchsorted(ts_ns, ns(t0) - ns(IMU_OVERLAP), side="left")) - 1)
    i1 = int(np.searchsorted(ts_ns, ns(t1) + ns(IMU_OVERLAP), side="right"))
    return ts_ns[i0:i1] / 1e9, traj.gyro[:len(ts_ns)][i0:i1], traj.acc[:len(ts_ns)][i0:i1]


@dataclasses.dataclass
class KeypointFrame:
    """One multiframe of projected landmarks (numpy only): per camera, K
    keypoint slots with uv, a validity mask, uint32 descriptors and the
    index of the landmark each slot shows (-1: empty)."""

    t: float
    uv: np.ndarray  # (C, K, 2)
    mask: np.ndarray  # (C, K) bool
    descriptors: np.ndarray  # (C, K, 16) uint32
    landmark: np.ndarray  # (C, K) int
    r_WS: np.ndarray  # ground truth
    q_WS: np.ndarray


def keypoint_frames(traj: SyntheticImu, landmarks: np.ndarray, rig, n_frames: int, K: int, seed: int,
                    frame_dt: float = 0.1, pixel_noise: float = 0.3, bit_flips: int = 6, border: float = 20.0):
    """Frames of a detector that finds every landmark in view: each landmark
    has its own random 512-bit descriptor, every view of it flips
    `bit_flips` random bits, and its keypoint is the projection at the true
    pose (float64 on the CPU) plus Gaussian pixel noise. Per camera the
    first K landmarks in view (at least `border` px inside the image) fill
    the slots in a random order; the rest of the slots are empty."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, (len(landmarks), 16), dtype=np.uint32)
    pts = torch.from_numpy(np.asarray(landmarks, np.float64))
    C = rig.num_cameras
    frames = []
    for fi in range(n_frames):
        t = fi * frame_dt
        i = int(round(t * 200))
        T_WS = kin.SE3(r=torch.from_numpy(traj.r[i]), q=torch.from_numpy(traj.q[i]))
        uv = np.zeros((C, K, 2))
        mask = np.zeros((C, K), bool)
        desc = np.zeros((C, K, 16), np.uint32)
        lm = np.full((C, K), -1)
        for c in range(C):
            T_SC = kin.SE3(r=rig.T_SC.r[c].detach().cpu().double(), q=rig.T_SC.q[c].detach().cpu().double())
            T_CW = kin.inverse(kin.compose(T_WS, T_SC))
            spec = rig.specs[c]
            proj, flags = pinhole.project(spec, rig.intrinsics[c].detach().cpu().double(),
                                          kin.transform_point(T_CW, pts))
            proj = proj.numpy()
            inside = ((flags.numpy() == pinhole.STATUS_OK) & (proj[:, 0] >= border)
                      & (proj[:, 0] <= spec.width - 1 - border) & (proj[:, 1] >= border)
                      & (proj[:, 1] <= spec.height - 1 - border))
            seen = rng.permutation(np.nonzero(inside)[0])[:K]
            n = len(seen)
            slots = rng.permutation(K)[:n]
            uv[c, slots] = proj[seen] + rng.normal(0.0, pixel_noise, (n, 2))
            mask[c, slots] = True
            lm[c, slots] = seen
            d = base[seen].copy()
            for j in range(n):
                for bit in rng.choice(512, bit_flips, replace=False):
                    d[j, bit // 32] ^= np.uint32(1 << (bit % 32))
            desc[c, slots] = d
        frames.append(KeypointFrame(t=t, uv=uv, mask=mask, descriptors=desc, landmark=lm,
                                    r_WS=traj.r[i].copy(), q_WS=traj.q[i].copy()))
    return frames


def association_scene(rig, P: int = 2, K: int = 48, seed: int = 3, pose_noise: float = 0.02) -> dict:
    """The numpy inputs of one association round (frontend.kernels.
    associate_multicam, in its argument names) on keypoint_frames of the
    smoke scene (trajectory seed 31, 600 landmarks at 4-8 m): sources are
    frames P-1, ..., 0 (newest first), the current frame is frame P. A
    source keypoint of an even landmark carries it (3D-2D), the others are
    free for 2D-2D; the current pose is the truth moved by `pose_noise` m;
    the current keypoints of every fourth landmark already carry it (RANSAC
    candidates). Poses as (r, q) pairs; descriptors uint32."""
    traj = simulate_trajectory(duration=1.2, seed=31, motion_scale=0.25)
    lms = make_landmarks(traj, 600, seed=32, radius=(4.0, 8.0))
    frames = keypoint_frames(traj, lms, rig, P + 1, K, seed=seed)
    r_SC, q_SC = rig.T_SC.r.detach().cpu().double(), rig.T_SC.q.detach().cpu().double()
    C = rig.num_cameras
    src, cur = frames[:P][::-1], frames[P]

    def T_WC(f, c):
        T = kin.compose(kin.SE3(r=torch.from_numpy(f.r_WS), q=torch.from_numpy(f.q_WS)),
                        kin.SE3(r=r_SC[c], q=q_SC[c]))
        return T.r.numpy(), T.q.numpy()

    lm_a = np.stack([f.landmark for f in src])  # (P, C, K)
    sel3d = (lm_a >= 0) & (lm_a % 2 == 0)
    sel_prev = (cur.landmark >= 0) & (cur.landmark % 4 == 1)
    poses = [[T_WC(f, c) for c in range(C)] for f in src]
    return dict(
        spec=(rig.specs[0].width, rig.specs[0].height, rig.specs[0].dist_type),
        intr=np.stack([i.detach().cpu().double().numpy() for i in rig.intrinsics]),
        desc_a=np.stack([f.descriptors for f in src]), sel3d=sel3d,
        hp=np.where(sel3d[..., None], np.concatenate([landmarks_of(lms, lm_a), np.ones((P, C, K, 1))], -1),
                    np.asarray([0.0, 0, 0, 1])),
        free2=(lm_a >= 0) & ~sel3d, uv_a=np.stack([f.uv for f in src]), std_a=np.full((P, C, K), 0.8 * 8.0 / 12.0),
        T_WS_b=(cur.r_WS + pose_noise, cur.q_WS),
        sb_b=np.concatenate([traj.v[int(round(cur.t * 200))], np.zeros(6)]),
        T_WC_a=(np.asarray([[t[0] for t in row] for row in poses]), np.asarray([[t[1] for t in row] for row in poses])),
        desc_b=cur.descriptors, free_b=cur.mask & ~sel_prev, uv_b=cur.uv, std_b=np.full((C, K), 0.8 * 8.0 / 12.0),
        sel_prev=sel_prev, pts_prev=np.where(sel_prev[..., None], landmarks_of(lms, cur.landmark), 0.0),
        T_SC=(r_SC.numpy(), q_SC.numpy()),
    )


def landmarks_of(landmarks: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Landmark positions at indices `idx` (any shape), zeros where -1."""
    return np.where((idx >= 0)[..., None], landmarks[np.maximum(idx, 0)], 0.0)


@dataclasses.dataclass
class VioScenario:
    """Rendered frames with the IMU stream that drives a per-frame VIO loop
    (numpy only)."""

    traj: SyntheticImu
    landmarks: np.ndarray
    times: list  # frame timestamps [s]
    images: list  # per frame, per camera (H, W) float32 images


def vio_scenario(rig, n_frames: int = 20, frame_dt: float = 0.1) -> VioScenario:
    """tests/test_vision_e2e.py::test_full_vision_tracking's world:
    simulate_trajectory(duration=2.0, seed=31, motion_scale=0.25), 260
    landmarks at 4-8 m (seed 32), rendered by render_scenario."""
    traj = simulate_trajectory(duration=max(2.0, n_frames * frame_dt), seed=31, motion_scale=0.25)
    lms = make_landmarks(traj, 260, seed=32, radius=(4.0, 8.0))
    return render_scenario(rig, traj, lms, n_frames, frame_dt)


def revisit_world(n_frames: int = 27, period: float = 2.0, frame_dt: float = 0.1) -> Tuple[SyntheticImu, np.ndarray]:
    """A world the rig sees all around and then again: one turn about the
    sensor's x axis every `period` s (the cameras look up, then sideways,
    down and up again) and a position of (0.1, 0.05, 0) m ⊙ (1 - cos ωt),
    ω = 2π / period, from rest, so from frame period / frame_dt on the
    frames repeat frame 0 on, once the start's landmarks have left the view.
    260 landmarks at 2-4 m (seed 32; at 4-8 m the 11 cm stereo baseline
    leaves the first keyframes' landmarks too coarse for a loop edge within
    0.02 rad of the VIO relative pose). Returns (trajectory, landmarks)."""
    w = 2 * np.pi / period
    sway = np.asarray([0.1, 0.05, 0.0])
    traj = simulate_trajectory(duration=n_frames * frame_dt, seed=31,
                               omega_fn=lambda t: np.array([w, 0.0, 0.0]),
                               acc_w_fn=lambda t: sway * w * w * np.cos(w * t))
    return traj, make_landmarks(traj, 260, seed=32, radius=(2.0, 4.0))


def revisit_scenario(rig, n_frames: int = 27, period: float = 2.0, frame_dt: float = 0.1) -> VioScenario:
    """revisit_world's frames, rendered by render_scenario."""
    traj, lms = revisit_world(n_frames, period, frame_dt)
    return render_scenario(rig, traj, lms, n_frames, frame_dt)


def gentle_mono_trajectory(n_frames: int, frame_dt: float = 0.1) -> SyntheticImu:
    """tests/test_vision_e2e.py::test_mono_gentle_motion_bootstrap's
    trajectory: seed 41, periodic excitation of period 8 s (angular rate
    0.25 rad/s, acceleration 0.9 m/s^2), n_frames + 2 frames long."""
    w = 2 * np.pi / 8.0
    return simulate_trajectory(
        duration=(n_frames + 2) * frame_dt, seed=41,
        omega_fn=lambda t: 0.25 * np.array([np.sin(w * t), np.cos(w * t), np.sin(2 * w * t)]),
        acc_w_fn=lambda t: np.array([0.9 * np.sin(w * t), 0.9 * np.cos(w * t), 0.4 * np.sin(2 * w * t)]))


def render_scenario(rig, traj: SyntheticImu, landmarks: np.ndarray, n_frames: int,
                    frame_dt: float = 0.1) -> VioScenario:
    """Frames every `frame_dt` from t = 0, each camera of `rig` rendered by
    render_world_image on the CPU in float64 at its true pose (any device:
    the rig is read back to the CPU)."""
    cpu = lambda x: x.detach().cpu().double()  # noqa: E731
    times, images = [], []
    for fi in range(n_frames):
        t = fi * frame_dt
        i = int(round(t * 200))
        T_WS = kin.SE3(r=torch.from_numpy(traj.r[i]), q=torch.from_numpy(traj.q[i]))
        images.append([
            render_world_image(rig.specs[c], cpu(rig.intrinsics[c]),
                               kin.compose(T_WS, kin.SE3(r=cpu(rig.T_SC.r[c]), q=cpu(rig.T_SC.q[c]))), landmarks)
            for c in range(rig.num_cameras)])
        times.append(t)
    return VioScenario(traj=traj, landmarks=landmarks, times=times, images=images)


def _cpu64(x: torch.Tensor) -> torch.Tensor:
    return x.detach().cpu().double()


def write_euroc_format(
    out_dir: str,
    traj: SyntheticImu,
    landmark_pts: np.ndarray,
    rig,
    frame_dt: float = 0.1,
    n_frames: int = 10,
    epoch_ns: int = 1_400_000_000_000_000_000,
) -> str:
    """Write the synthetic world as an EuRoC ASL directory (mav0/...): per
    camera PNG frames named by nanosecond timestamp, imu0/data.csv, and the
    ground truth, the files and text of the JAX package's writer, so the
    EuRoC loader and the app run end to end without the real dataset.
    Frames are rendered by render_world_image on the CPU in float64 (any
    device: the rig is read back to the CPU), truncated to uint8 and written
    by png.write_png_gray. Returns the mav0 path."""
    import os

    from .png import write_png_gray

    mav0 = os.path.join(out_dir, "mav0")
    os.makedirs(os.path.join(mav0, "imu0"), exist_ok=True)
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i in range(len(traj.ts)):
            t = epoch_ns + int(round(traj.ts[i] * 1e9))
            g, a = traj.gyro[i], traj.acc[i]
            f.write(f"{t},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n")

    gt_dir = os.path.join(mav0, "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp,p,q,v\n")
        for i in range(len(traj.ts)):
            t = epoch_ns + int(round(traj.ts[i] * 1e9))
            p, q, v = traj.r[i], traj.q[i], traj.v[i]
            # EuRoC order: p(3), q(wxyz), v(3)
            f.write(f"{t},{p[0]},{p[1]},{p[2]},{q[3]},{q[0]},{q[1]},{q[2]},{v[0]},{v[1]},{v[2]}\n")

    imu_rate = int(round(1.0 / (traj.ts[1] - traj.ts[0])))
    for cam in range(rig.num_cameras):
        d = os.path.join(mav0, f"cam{cam}", "data")
        os.makedirs(d, exist_ok=True)
        T_SC = kin.SE3(r=_cpu64(rig.T_SC.r[cam]), q=_cpu64(rig.T_SC.q[cam]))
        for fi in range(n_frames):
            t = fi * frame_dt
            idx = int(round(t * imu_rate))
            if idx >= len(traj.ts):
                break
            T_WS = kin.SE3(r=torch.from_numpy(traj.r[idx]), q=torch.from_numpy(traj.q[idx]))
            img = render_world_image(rig.specs[cam], _cpu64(rig.intrinsics[cam]), kin.compose(T_WS, T_SC),
                                     landmark_pts)
            ts_ns = epoch_ns + int(round(t * 1e9))
            write_png_gray(os.path.join(d, f"{ts_ns}.png"), img.astype(np.uint8))
    return mav0


def render_textured_plane(
    spec: CameraSpec,
    intrinsics: torch.Tensor,
    T_WC: kin.SE3,
    texture: np.ndarray,  # (Ht, Wt) float grayscale
    plane_z: float = 0.0,
    plane_scale: float = 100.0,  # texture pixels per world meter
    background: float = 90.0,
) -> np.ndarray:
    """Render the camera viewing a textured plane z = plane_z (world).

    Every camera pixel's ray is intersected with the plane and bilinearly
    sampled from the texture, wrapped so the plane is endless (rays that
    meet the plane behind or within 5 cm of the camera get the background
    value); no occlusion. Back-projection runs in float64 on the CPU
    whatever the device of `intrinsics` and `T_WC`; the rest is numpy, as in
    the JAX package."""
    H, W = spec.height, spec.width
    us, vs = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    uv = torch.from_numpy(np.stack([us.ravel(), vs.ravel()], axis=-1)).double()
    rays_C = pinhole.back_project(spec, _cpu64(intrinsics), uv).numpy()  # (N, 3)
    C_WC = kin.quat_to_matrix(_cpu64(T_WC.q)).numpy()
    o_W = _cpu64(T_WC.r).numpy()
    d_W = rays_C @ C_WC.T  # (N, 3)
    dz = d_W[:, 2]
    t = (plane_z - o_W[2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
    hit = t > 0.05
    p_W = o_W[None, :] + t[:, None] * d_W
    tx = p_W[:, 0] * plane_scale
    ty = p_W[:, 1] * plane_scale
    Ht, Wt = texture.shape
    x0 = np.floor(tx).astype(np.int64)
    y0 = np.floor(ty).astype(np.int64)
    fx = (tx - x0).astype(np.float32)
    fy = (ty - y0).astype(np.float32)
    x0m, y0m = x0 % Wt, y0 % Ht
    x1m, y1m = (x0 + 1) % Wt, (y0 + 1) % Ht
    v = (
        texture[y0m, x0m] * (1 - fx) * (1 - fy)
        + texture[y0m, x1m] * fx * (1 - fy)
        + texture[y1m, x0m] * (1 - fx) * fy
        + texture[y1m, x1m] * fx * fy
    )
    img = np.where(hit, v, background).astype(np.float32)
    return img.reshape(H, W)


def noise_texture(size: int = 1024, seed: int = 0) -> np.ndarray:
    """A (size, size) float32 grayscale texture in [0, 255] that tiles
    seamlessly: white noise from numpy's generator `seed`, smoothed by a
    periodic Gaussian of 1, 3 and 9 texture pixels, each scale normalized
    and weighted 1, 0.8 and 0.6, summed and stretched to a mean of 128 and a
    standard deviation of 48. Texture at several scales for
    render_textured_plane, made in code."""
    rng = np.random.default_rng(seed)
    f = np.fft.fftfreq(size)
    r2 = f[:, None] ** 2 + f[None, :] ** 2
    out = np.zeros((size, size))
    for sigma, w in ((1.0, 1.0), (3.0, 0.8), (9.0, 0.6)):
        noise = np.fft.fft2(rng.normal(size=(size, size)))
        layer = np.fft.ifft2(noise * np.exp(-2.0 * (np.pi * sigma) ** 2 * r2)).real
        out += w * layer / layer.std()
    out = 128.0 + 48.0 * (out - out.mean()) / out.std()
    return np.clip(out, 0.0, 255.0).astype(np.float32)


# ---------------------------------------------------------------------------
# pose-graph scenarios: plain numpy, so that either package's PoseGraph and
# PoseGraphManager can be fed the same values
# ---------------------------------------------------------------------------


def circle_pose_graph(n_nodes: int, seed: int = 0) -> dict:
    """The drifting circle of scripts/bench_posegraph.py::build_circle_graph,
    as the calls that build it, with the same numpy draws: `nodes` of
    (id, r, q, fixed) (node i at angle 2πi/n on a circle of circumference n,
    with a N(0, 0.05 i/n) accumulated drift; node 0 fixed), `edges` of
    (i, j, t, q, sqrt_info): the odometry chain (the world-frame step plus
    N(0, 0.01) noise, identity rotation, 10·I) and one loop edge from node
    n-1 to 0. For PoseGraph(node_capacity=n, edge_capacity=2n)."""
    rng = np.random.default_rng(seed)
    radius = n_nodes / (2 * np.pi)
    nodes = []
    for i in range(n_nodes):
        a = 2 * np.pi * i / n_nodes
        r = np.asarray([radius * np.cos(a), radius * np.sin(a), 0.0])
        r += rng.normal(0, 0.05 * i / n_nodes, 3)
        nodes.append((i, r, np.asarray([0.0, 0.0, np.sin(a / 2), np.cos(a / 2)]), i == 0))
    identity, info = np.asarray([0.0, 0, 0, 1.0]), np.eye(6) * 10.0
    edges = [(i, i + 1, nodes[i + 1][1] - nodes[i][1] + rng.normal(0, 0.01, 3), identity, info)
             for i in range(n_nodes - 1)]
    edges.append((n_nodes - 1, 0, nodes[0][1] - nodes[n_nodes - 1][1], identity, info))
    return dict(nodes=nodes, edges=edges)


def fill_pose_graph(graph, spec: dict):
    """Add circle_pose_graph's nodes and edges to a PoseGraph of either
    package; returns it."""
    for kf_id, r, q, fixed in spec["nodes"]:
        graph.add_node(kf_id, r, q, fixed=fixed)
    for i, j, t, q, info in spec["edges"]:
        graph.add_edge(i, j, t, q, info)
    return graph


def square_loop_keyframes(rng: np.random.Generator, n_landmarks: int = 60, words: bool = False,
                          side: float = 6.0, per_side: int = 5, drift=(0.02, 0.015, 0.0)) -> list:
    """The keyframes of tests/test_posegraph.py::TestManagerEndToEnd: a
    square path, `per_side` keyframes a side of `side` m, plus a revisit of
    the start (21 by default). Keyframe i sees its own cloud of `n_landmarks`
    points uniform in ±2.5 m around (x_i, y_i, 6) with random descriptors,
    drawn from `rng` in the JAX test's order; the revisit re-observes
    keyframe 0's points and descriptors. The VIO pose drifts by `drift` a
    keyframe. Descriptors are (n, 64) uint8, or with `words` (n, 16)
    uint32. Each keyframe: dict(gt, vio, landmarks_W, descriptors,
    bearings), the bearings seen from the true pose."""
    gt = []
    for leg, (dx, dy) in enumerate([(1, 0), (0, 1), (-1, 0), (0, -1)]):
        x0, y0 = [0, side, side, 0][leg], [0, 0, side, side][leg]
        for k in range(per_side):
            t = (k / per_side) * side
            gt.append((np.array([x0 + dx * t, y0 + dy * t, 0.0]), np.array([0.0, 0.0, 0.0, 1.0])))
    gt.append(gt[0])
    clouds, descs = [], []
    for i in range(len(gt) - 1):
        clouds.append(np.asarray((gt[i][0][0], gt[i][0][1], 6.0)) + rng.uniform(-2.5, 2.5, (n_landmarks, 3)))
        descs.append(rng.integers(0, 2**32, (n_landmarks, 16), dtype=np.uint32) if words
                     else rng.integers(0, 256, size=(n_landmarks, 64), dtype=np.uint8))
    clouds.append(clouds[0])
    descs.append(descs[0])
    from ..kinematics import np_se3

    def bearings(points_W, r_WS, q_WS):  # unit bearings in the sensor (= camera) frame
        p_S = (points_W - r_WS) @ np_se3.quat_to_matrix(q_WS)  # C^T (p - r)
        return p_S / np.linalg.norm(p_S, axis=1, keepdims=True)

    drift = np.asarray(drift)
    return [dict(gt=gt[i], vio=(gt[i][0] + drift * i, gt[i][1]), landmarks_W=clouds[i], descriptors=descs[i],
                 bearings=bearings(clouds[i], *gt[i])) for i in range(len(gt))]
