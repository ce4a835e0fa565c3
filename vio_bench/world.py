"""The benchmark's synthetic world: one closed lap of motion, its IMU and its
rendered camera images, made from a seed and fed again lap after lap.

Frozen copies, rewritten for a periodic stream, of what the port's
`okvis_tpu_torch/datasets/synthetic.py` generates:
- `make_landmarks` (a landmark shell around the lap's centre);
- `render_world_image` (each landmark stamped as an 11 x 11 patch of 3 x 3
  blocks at its projection, no occlusion, on a mild gradient with noise),
  vectorised over all frames of a lap and kept in whole grey levels, so
  the sums are exact in any order and every image is a uint8 camera frame;
- `simulate_trajectory`'s exact IMU readings, here from a closed form:
  position p(t) = sum_k c_k (1 - cos k w t) (accelerations in cosines of
  the lap's harmonics, from rest), orientation R(t) = Exp(W t a) Exp(theta(t))
  with theta(t) = sum_k b_k sin(k w t + psi_k), so both repeat every lap;
  `revisit_world`'s spin is the case of one turn a lap about the x axis.

The IMU readings are the closed form's, with the sensor's white noise and a
constant bias drawn from the seed; one lap of readings is drawn and repeated,
so lap n + 1 equals lap n sample for sample, as its images do frame for
frame. Imports torch and numpy only.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

GRAVITY_DIR = np.array([0.0, 0.0, 1.0])
PATCH = 11
EPOCH_NS = 1_403_636_580_000_000_000  # a EuRoC-like start time: the port sees 19-digit stamps


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use (`stream`) of a run's seed; any
    whole number is a seed."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def skew(v: np.ndarray) -> np.ndarray:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = np.zeros(v.shape[:-1])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([np.stack([z, -w, y], -1), np.stack([w, z, -x], -1), np.stack([-y, x, z], -1)], -2)


def so3_exp(v: np.ndarray) -> np.ndarray:
    """Rodrigues: (..., 3) rotation vectors -> (..., 3, 3)."""
    th = np.linalg.norm(v, axis=-1)[..., None, None]
    K = skew(v)
    small = th < 1e-8
    th_s = np.where(small, 1.0, th)
    a = np.where(small, 1.0 - th ** 2 / 6.0, np.sin(th_s) / th_s)
    b = np.where(small, 0.5 - th ** 2 / 24.0, (1.0 - np.cos(th_s)) / th_s ** 2)
    return np.eye(3) + a * K + b * (K @ K)


def so3_right_jacobian(v: np.ndarray) -> np.ndarray:
    """J_r(v), with R(t) = Exp(v(t)) having body rate J_r(v) dv/dt."""
    th = np.linalg.norm(v, axis=-1)[..., None, None]
    K = skew(v)
    small = th < 1e-6
    th_s = np.where(small, 1.0, th)
    a = np.where(small, 0.5 - th ** 2 / 24.0, (1.0 - np.cos(th_s)) / th_s ** 2)
    b = np.where(small, 1.0 / 6.0 - th ** 2 / 120.0, (th_s - np.sin(th_s)) / th_s ** 3)
    return np.eye(3) - a * K + b * (K @ K)


@dataclasses.dataclass
class Motion:
    """One lap's closed-form motion (seconds, metres, radians)."""

    lap_s: float
    harmonics_p: np.ndarray  # (Kp,) harmonic numbers of the position
    c: np.ndarray  # (Kp, 3) position amplitudes c_k
    harmonics_r: np.ndarray  # (Kr,)
    b: np.ndarray  # (Kr, 3) rotation-vector amplitudes b_k
    psi: np.ndarray  # (Kr, 3) phases
    spin_axis: np.ndarray  # (3,) unit
    spin_rate: float  # rad/s, a whole number of turns a lap

    @property
    def w(self) -> float:
        return 2.0 * np.pi / self.lap_s

    def _pva(self, t: np.ndarray):
        kw = self.harmonics_p[:, None] * self.w  # (Kp, 1)
        ph = kw[None] * t[:, None, None]  # (N, Kp, 1)
        p = np.sum(self.c[None] * (1.0 - np.cos(ph)), axis=1)
        v = np.sum(self.c[None] * kw[None] * np.sin(ph), axis=1)
        a = np.sum(self.c[None] * (kw[None] ** 2) * np.cos(ph), axis=1)
        return p, v, a

    def _theta(self, t: np.ndarray):
        kw = self.harmonics_r[:, None] * self.w
        ph = kw[None] * t[:, None, None] + self.psi[None]
        return np.sum(self.b[None] * np.sin(ph), axis=1), np.sum(self.b[None] * kw[None] * np.cos(ph), axis=1)

    def rotation(self, t: np.ndarray) -> np.ndarray:
        theta, _ = self._theta(t)
        spin = so3_exp(self.spin_axis[None] * (self.spin_rate * t)[:, None])
        return spin @ so3_exp(theta)

    def position(self, t: np.ndarray) -> np.ndarray:
        return self._pva(t)[0]

    def velocity(self, t: np.ndarray) -> np.ndarray:
        return self._pva(t)[1]

    def imu(self, t: np.ndarray, g: float):
        """Exact (gyro, acc) in the body frame at times `t`."""
        theta, dtheta = self._theta(t)
        E = so3_exp(theta)
        gyro = (np.swapaxes(E, -1, -2) @ (self.spin_axis * self.spin_rate))[..., :] \
            + (so3_right_jacobian(theta) @ dtheta[..., None])[..., 0]
        _, _, a = self._pva(t)
        R = self.rotation(t)
        acc = (np.swapaxes(R, -1, -2) @ (a + g * GRAVITY_DIR)[..., None])[..., 0]
        return gyro, acc


def draw_motion(traffic: dict, seed: int) -> Motion:
    """The lap's motion: amplitudes within the traffic file's ranges, random
    signs and phases, from the seed."""
    rng = rng_for(seed, 1)
    lap_s = float(traffic["lap_s"])
    w = 2.0 * np.pi / lap_s
    pos, rot = traffic["position"], traffic["rotation"]
    hp = np.asarray(pos["harmonics"], float)
    acc_amp = np.stack([rng.uniform(np.asarray(lo, float), np.asarray(hi, float))
                        for lo, hi in zip(pos["accel_mps2_lo"], pos["accel_mps2_hi"])])  # (Kp, 3)
    c = acc_amp * rng.choice([-1.0, 1.0], size=acc_amp.shape) / (hp[:, None] * w) ** 2
    hr = np.asarray(rot["harmonics"], float)
    rate_amp = np.stack([rng.uniform(np.asarray(lo, float), np.asarray(hi, float))
                         for lo, hi in zip(rot["rate_radps_lo"], rot["rate_radps_hi"])])  # (Kr, 3)
    b = rate_amp * rng.choice([-1.0, 1.0], size=rate_amp.shape) / (hr[:, None] * w)
    psi = rng.uniform(0.0, 2.0 * np.pi, b.shape)
    axis = np.asarray(rot["spin_axis"], float)
    return Motion(lap_s=lap_s, harmonics_p=hp, c=c, harmonics_r=hr, b=b, psi=psi,
                  spin_axis=axis / np.linalg.norm(axis), spin_rate=w * float(rot["spin_turns_per_lap"]))


def make_landmarks(center: np.ndarray, n: int, radius, rng: np.random.Generator) -> np.ndarray:
    """Landmark shell around `center` (copy of synthetic.make_landmarks)."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rad = rng.uniform(radius[0], radius[1], (n, 1))
    return center + dirs * rad


def make_textures(n: int, rng: np.random.Generator, amplitude: int) -> np.ndarray:
    """(n, 11, 11) whole-number patches of 3 x 3 blocks, each block uniform in
    [-amplitude, amplitude] (render_world_image's blocky texture)."""
    blocks = rng.integers(-amplitude, amplitude + 1, (n, PATCH // 3 + 1, PATCH // 3 + 1))
    return np.repeat(np.repeat(blocks, 3, axis=1), 3, axis=2)[:, :PATCH, :PATCH].astype(np.float32)


def distort_radtan(xy: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Radial-tangential distortion (k1, k2, p1, p2) of normalised points."""
    x, y = xy[..., 0], xy[..., 1]
    k1, k2, p1, p2 = d[0], d[1], d[2], d[3]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def render(cameras: list, R_WC: np.ndarray, r_WC: np.ndarray, landmarks: np.ndarray, textures: np.ndarray,
           scene: dict, seed: int, device, chunk: int = 40) -> np.ndarray:
    """(F, C, H, W) uint8 images: a background of whole grey levels (the
    scene's level, a mild gradient and noise, drawn on the device from the
    seed), every landmark in front of a camera and inside its image stamped
    at its rounded projection, clipped to [0, 255]. `R_WC`, `r_WC`:
    (F, C, 3, 3), (F, C, 3) camera poses."""
    F, C = R_WC.shape[:2]
    W, H = cameras[0]["image_dimension"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    slope = (torch.linspace(0, 10, H, device=dev)[:, None] + torch.linspace(0, 7, W, device=dev)[None, :])
    half = PATCH // 2
    lm = torch.as_tensor(landmarks, dtype=torch.float64, device=dev)
    tex = torch.as_tensor(textures, device=dev).reshape(len(landmarks), -1)
    dy, dx = torch.meshgrid(torch.arange(-half, half + 1, device=dev), torch.arange(-half, half + 1, device=dev),
                            indexing="ij")
    offs = (dy * W + dx).reshape(-1)
    out = np.empty((F, C, H, W), np.uint8)
    for f0 in range(0, F, chunk):
        f1 = min(F, f0 + chunk)
        noise = torch.randn((f1 - f0, C, H, W), generator=gen, device=dev) * float(scene["image_noise"])
        img = torch.round(float(scene["background"]) + slope + noise)
        flat = img.reshape(-1)
        for c, cam in enumerate(cameras):
            R = torch.as_tensor(R_WC[f0:f1, c], dtype=torch.float64, device=dev)
            t = torch.as_tensor(r_WC[f0:f1, c], dtype=torch.float64, device=dev)
            p_C = torch.einsum("fji,flj->fli", R, lm[None] - t[:, None])  # R^T (p - t)
            z = p_C[..., 2]
            xy = p_C[..., :2] / torch.where(z > 1e-6, z, torch.ones_like(z))[..., None]
            d = torch.as_tensor(cam["distortion_coefficients"], dtype=torch.float64, device=dev)
            xyd = distort_radtan(xy, d)
            fu, fv = cam["focal_length"]
            cu, cv = cam["principal_point"]
            u = torch.round(fu * xyd[..., 0] + cu)
            v = torch.round(fv * xyd[..., 1] + cv)
            ok = (z > 0.05) & (u >= half) & (u < W - half) & (v >= half) & (v < H - half)
            fi, li = torch.nonzero(ok, as_tuple=True)
            if fi.numel() == 0:
                continue
            centre = ((fi * C + c) * H + v[fi, li].long()) * W + u[fi, li].long()
            flat.index_add_(0, (centre[:, None] + offs[None]).reshape(-1), tex[li].reshape(-1))
        out[f0:f1] = img.clamp_(0, 255).to(torch.uint8).cpu().numpy()
    return out


@dataclasses.dataclass
class Stream:
    """One lap of a run's input, fed again lap after lap: frame n is lap
    frame n mod lap_frames at n / camera_hz s, IMU sample i is lap sample
    i mod lap_samples at i / imu_hz s."""

    motion: Motion
    camera_hz: int
    imu_hz: int
    images: np.ndarray  # (lap_frames, C, H, W) uint8
    gyro: np.ndarray  # (lap_samples, 3) measured
    acc: np.ndarray  # (lap_samples, 3) measured
    landmarks: np.ndarray  # (L, 3)
    T_SC: np.ndarray  # (C, 4, 4)

    def __post_init__(self):
        # one array object per lap frame and camera, fed as is every lap
        self.views = [list(frame) for frame in self.images]

    @property
    def lap_frames(self) -> int:
        return self.images.shape[0]

    @property
    def lap_samples(self) -> int:
        return self.gyro.shape[0]

    def frame_ns(self, n: int) -> int:
        return EPOCH_NS + n * (1_000_000_000 // self.camera_hz)

    def imu_ns(self, i: int) -> int:
        return EPOCH_NS + i * (1_000_000_000 // self.imu_hz)

    def frame_images(self, n: int) -> list:
        return self.views[n % self.lap_frames]

    def imu_sample(self, i: int):
        j = i % self.lap_samples
        return self.gyro[j], self.acc[j]

    def truth(self, t_ns: np.ndarray):
        """(positions (N, 3), rotations (N, 3, 3), velocities (N, 3)) of the
        body at stamps `t_ns`, from the closed form (lap-periodic)."""
        t = ((np.asarray(t_ns, np.int64) - EPOCH_NS) % int(round(self.motion.lap_s * 1e9))) / 1e9
        return self.motion.position(t), self.motion.rotation(t), self.motion.velocity(t)


def camera_poses(motion: Motion, t: np.ndarray, T_SC: np.ndarray):
    """(R_WC (N, C, 3, 3), r_WC (N, C, 3)) at times `t`."""
    R_WS = motion.rotation(t)
    r_WS = motion.position(t)
    R_WC = R_WS[:, None] @ T_SC[None, :, :3, :3]
    r_WC = r_WS[:, None] + (R_WS[:, None] @ T_SC[None, :, :3, 3:])[..., 0]
    return R_WC, r_WC


def make_scene(scene: dict, motion: Motion, seed: int) -> tuple:
    """(landmarks (L, 3), textures (L, 11, 11)) from the seed: a shell
    around the lap's centre."""
    rng = rng_for(seed, 3)
    centre = motion.position(np.linspace(0.0, motion.lap_s, 200, endpoint=False)).mean(axis=0)
    landmarks = make_landmarks(centre, int(scene["landmarks"]), scene["radius_m"], rng)
    return landmarks, make_textures(len(landmarks), rng, int(scene["texture_amplitude"]))


def make_stream(config: dict, traffic: dict, seed: int, device) -> Stream:
    """The run's stream: the lap's motion, IMU and rendered images."""
    cameras = config["cameras"]
    T_SC = np.stack([np.asarray(c["T_SC"], float).reshape(4, 4) for c in cameras])
    motion = draw_motion(traffic, seed)
    cam_hz, imu_hz = int(config["camera_rate_hz"]), int(config["imu_rate_hz"])
    lap_frames = int(round(motion.lap_s * cam_hz))
    lap_samples = int(round(motion.lap_s * imu_hz))
    if abs(lap_frames / cam_hz - motion.lap_s) > 1e-9 or abs(lap_samples / imu_hz - motion.lap_s) > 1e-9:
        raise ValueError("the lap must hold a whole number of frames and IMU samples")

    # the sensor: white noise at the sensor's densities, constant biases
    sensor = config["imu_sensor"]
    rng = rng_for(seed, 2)
    ts = np.arange(lap_samples) / imu_hz
    gyro, acc = motion.imu(ts, float(config["imu"]["g"]))
    bg = rng.uniform(*sensor["gyro_bias_radps"], 3) * rng.choice([-1.0, 1.0], 3)
    ba = rng.uniform(*sensor["accel_bias_mps2"], 3) * rng.choice([-1.0, 1.0], 3)
    gyro = gyro + bg + rng.normal(0, sensor["gyro_noise_density"] * np.sqrt(imu_hz), gyro.shape)
    acc = acc + ba + rng.normal(0, sensor["accel_noise_density"] * np.sqrt(imu_hz), acc.shape)

    landmarks, textures = make_scene(traffic["scene"], motion, seed)

    R_WC, r_WC = camera_poses(motion, np.arange(lap_frames) / cam_hz, T_SC)
    images = render(cameras, R_WC, r_WC, landmarks, textures, traffic["scene"], seed, device)
    return Stream(motion=motion, camera_hz=cam_hz, imu_hz=imu_hz, images=images, gyro=gyro, acc=acc,
                  landmarks=landmarks, T_SC=T_SC)
