#!/usr/bin/env python3
"""The JAX package's ThreadedVio in the three estimator modes that
chip_smoke.py's modes phase runs through the port's ThreadedVio on the
card, on the same frames, on the CPU, in float32 (or float64). A CPU run of
the reference; its numbers are not device metrics.

VioParameters are built in code (the EuRoC defaults, 400 keypoints a camera
at threshold 40, the default window); blocking mode; the IMU fed up to 25 ms
past each frame, then the images, then wait_idle, with timestamps rounded
to the ns (utils.time.ns_from_sec), as the runtime phase feeds. The frames
are rendered on the CPU by okvis_tpu_torch.datasets.synthetic, so both
packages see the same images:

- pyramid: the runtime phase's 20 stereo frames (vio_scenario) with
  detection_octaves = 2 and a detection mask a camera that blanks the left
  64 columns and the bottom 48 rows;
- per_state: the same frames with both relative extrinsics sigmas nonzero
  (1e-4 m/sqrt(s), 1e-5 rad/sqrt(s); absolute 0.05 m, 0.02 rad, as
  tests/test_pipeline.py:455), the estimator's camera-1 translation 4, -3,
  2 mm off the truth that rendered the frames (tests/test_estimator.py:204);
- mono: camera 0 alone on tests/test_vision_e2e.py:158's gentle-motion
  world (trajectory seed 41, 300 landmarks at 4-9 m, seed 42), 60 frames;
  a third argument FRAMES:FED renders a world of FRAMES frames (its
  trajectory and landmark cloud depend on the length) and feeds the first
  FED (chip_smoke.py's modes phase feeds 40 of 60: 60:40).

Prints one JSON line a mode: frames tracked, the ATE (Umeyama-aligned,
eval/ate.py), landmarks and keyframes at the end, the frame after which
tracking was initialized, per-frame position errors, for per_state the
camera-1 calibration error before and after (the newest state's block),
and wall seconds.

    JAX_PLATFORMS=cpu python scripts/jax_modes.py float32 [pyramid,per_state,mono] [FRAMES:FED]

Several minutes on a CPU, most of them compiling and rendering.
"""

import json
import os
import sys
import time

import jax

DTYPE = sys.argv[1] if len(sys.argv) > 1 else "float32"
MODES = sys.argv[2].split(",") if len(sys.argv) > 2 else ["pyramid", "per_state", "mono"]
MONO_FRAMES, MONO_FED = map(int, (sys.argv[3] if len(sys.argv) > 3 else "60:60").split(":"))
if DTYPE not in ("float32", "float64"):
    sys.exit(f"usage: {sys.argv[0]} float32|float64 [modes]")
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", DTYPE == "float64")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from okvis_tpu import kinematics as kin  # noqa: E402
from okvis_tpu.cameras import NCameraSystem  # noqa: E402
from okvis_tpu.config.parameters import VioParameters  # noqa: E402
from okvis_tpu.datasets.synthetic import euroc_stereo_rig  # noqa: E402
from okvis_tpu.eval.ate import ate_rmse  # noqa: E402
from okvis_tpu.pipeline import ThreadedVio  # noqa: E402
from okvis_tpu.utils.ids import IdProvider  # noqa: E402
from okvis_tpu.utils.time import ns_from_sec  # noqa: E402
from okvis_tpu_torch import kinematics as tkin  # noqa: E402
from okvis_tpu_torch.cameras.ncamera import NCameraSystem as TorchRig  # noqa: E402
from okvis_tpu_torch.datasets import synthetic as port_synthetic  # noqa: E402

N_KEYPOINTS = 400
NS = 1_000_000_000
# the modes phase's settings (chip_smoke.py MODES_*)
STEREO_FRAMES = 20
MASK_LEFT, MASK_BOTTOM = 64, 48
OFFSET = np.asarray([0.004, -0.003, 0.002])
PER_STATE_SIGMAS = dict(sigma_c_relative_translation=1e-4, sigma_c_relative_orientation=1e-5,
                        sigma_absolute_translation=0.05, sigma_absolute_orientation=0.02)


def port_rig(cameras):
    specs, T_SC, intr = port_synthetic.euroc_stereo_rig(device="cpu")
    return TorchRig(specs=specs[:cameras], T_SC=tkin.SE3(r=T_SC.r[:cameras], q=T_SC.q[:cameras]),
                    intrinsics=intr[:cameras])


def jax_rig(cameras, offset=None):
    specs, T_SC, intr = euroc_stereo_rig()
    r = np.asarray(T_SC.r)[:cameras].copy()
    if offset is not None:
        r[1] += offset
    rig = NCameraSystem(specs=tuple(specs[:cameras]), T_SC=kin.SE3(r=jnp.asarray(r), q=T_SC.q[:cameras]),
                        intrinsics=list(intr[:cameras]))
    rig.compute_overlaps()
    return rig


def run(mode: str) -> dict:
    params = VioParameters()
    params.optimization.max_num_keypoints = N_KEYPOINTS
    params.optimization.detection_threshold = 40.0
    if mode == "mono":
        truth = port_rig(1)
        traj = port_synthetic.gentle_mono_trajectory(MONO_FRAMES)
        lms = port_synthetic.make_landmarks(traj, 300, seed=42, radius=(4.0, 9.0))
        scene = port_synthetic.render_scenario(truth, traj, lms, MONO_FRAMES)
        rig = jax_rig(1)
    else:
        scene = port_synthetic.vio_scenario(port_rig(2), STEREO_FRAMES)
        rig = jax_rig(2, OFFSET if mode == "per_state" else None)
    if mode == "pyramid":
        params.optimization.detection_octaves = 2
    if mode == "per_state":
        for k, v in PER_STATE_SIGMAS.items():
            setattr(params.camera_params, k, v)
    traj = scene.traj
    IdProvider.reset()
    vio = ThreadedVio(params, rig=rig, blocking=True, dtype=jnp.float32 if DTYPE == "float32" else jnp.float64)
    if mode == "pyramid":
        mask = np.ones((480, 752), bool)
        mask[:, :MASK_LEFT] = False
        mask[-MASK_BOTTOM:] = False
        vio.frontend.cfg.detection_masks = (mask, mask)
    true_r1 = np.asarray(euroc_stereo_rig()[1].r)[1]
    ts_ns = [int(ns_from_sec(t)) for t in traj.ts]
    imu_i, init_frame = 0, None
    t0 = time.perf_counter()
    fed = MONO_FED if mode == "mono" else len(scene.times)
    for fi, (t, images) in enumerate(list(zip(scene.times, scene.images))[:fed]):
        t_ns = int(ns_from_sec(t))
        while imu_i < len(ts_ns) and ts_ns[imu_i] <= t_ns + 25_000_000:
            vio.add_imu_measurement(ts_ns[imu_i], traj.gyro[imu_i], traj.acc[imu_i])
            imu_i += 1
        for c, image in enumerate(images):
            vio.add_image(t_ns, c, image)
        vio.wait_idle(timeout=600)
        if vio.frontend.is_initialized and init_frame is None:
            init_frame = fi
    vio.shutdown()
    seconds = time.perf_counter() - t0
    states = vio.trajectory
    est_ts = np.asarray([s.timestamp_ns for s in states])
    est_p = np.stack([np.asarray(s.T_WS.r, np.float64) for s in states])
    err = lambda t, r: float(np.linalg.norm(r - traj.r[int(round(t / NS * 200))]))  # noqa: E731
    out = dict(
        mode=mode, dtype=DTYPE, device="cpu", frames=len(scene.times), frames_fed=fed, frames_tracked=len(states),
        ate_m=ate_rmse(est_ts, est_p, (traj.ts * NS).astype(np.int64), traj.r),
        landmarks=vio.estimator.num_landmarks(), keyframes=sum(s.is_keyframe for s in states),
        initialized_at_frame=init_frame, position_error_m=[err(s.timestamp_ns, p) for s, p in zip(states, est_p)],
        seconds=seconds)
    if mode == "per_state":
        est = vio.estimator
        newest = est._last_state()
        out["calibration_error_m"] = dict(
            before=float(np.linalg.norm(OFFSET)),
            after=float(np.linalg.norm(np.asarray(est.r_SC_t)[newest.slot, 1] - true_r1)))
    return out


def main() -> None:
    for mode in MODES:
        print(json.dumps(run(mode)), flush=True)


if __name__ == "__main__":
    main()
