#!/usr/bin/env python3
"""The JAX package's per-frame VIO loop on the rendered stereo frames that
chip_smoke.py's vio phase runs on the card, on the CPU, in float32 or
float64. A CPU run of the reference; its numbers are not device metrics.

The world is tests/test_vision_e2e.py::test_full_vision_tracking's
(okvis_tpu_torch.datasets.synthetic.vio_scenario: 20 frames 0.1 s apart,
rendered on the CPU, so both packages see the same images), the EuRoC
stereo rig with overlaps, 400 keypoints a camera at threshold 40, the
Estimator's default window (S = 9, L = 512, O = 2048), LM + Newton-Schulz.
The loop is the runtime's blocking per-frame path (ThreadedVio's frame
consumer and processing loop, without threads or queues): the predicted
pose (or the IMU's gravity before the first state), detect_and_describe_multi,
add_states with the fetch deferred, the multiframe, last_prop_device,
data_association_and_initialization, set_keyframe, optimize,
apply_marginalization_strategy, with the IMU fed 25 ms past each frame.

Prints one JSON line: the ATE (Umeyama-aligned, eval/ate.py), frames
tracked, landmarks and keyframes at the end, the frame at which tracking
initialized, per-frame position errors and wall seconds.

    JAX_PLATFORMS=cpu python scripts/jax_vio_loop.py float32
    JAX_PLATFORMS=cpu python scripts/jax_vio_loop.py float64

A few minutes each on a CPU, most of them compiling.
"""

import json
import os
import sys
import time

import jax

DTYPE = sys.argv[1] if len(sys.argv) > 1 else "float32"
if DTYPE not in ("float32", "float64"):
    sys.exit(f"usage: {sys.argv[0]} float32|float64")
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", DTYPE == "float64")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from okvis_tpu.cameras import NCameraSystem  # noqa: E402
from okvis_tpu.datasets.synthetic import euroc_stereo_rig  # noqa: E402
from okvis_tpu.estimator import Estimator  # noqa: E402
from okvis_tpu.eval.ate import ate_rmse  # noqa: E402
from okvis_tpu.frontend.frame import MultiFrame  # noqa: E402
from okvis_tpu.frontend.frontend import Frontend, FrontendConfig  # noqa: E402
from okvis_tpu.imu import ImuParams  # noqa: E402
from okvis_tpu.imu.preintegration import init_pose_from_imu  # noqa: E402
from okvis_tpu.utils.ids import IdProvider  # noqa: E402
from okvis_tpu_torch.cameras.ncamera import NCameraSystem as TorchRig  # noqa: E402
from okvis_tpu_torch.datasets import synthetic as port_synthetic  # noqa: E402

N_FRAMES = 20
N_KEYPOINTS = 400
NS = 1_000_000_000


def main() -> None:
    specs, T_SC, intr = port_synthetic.euroc_stereo_rig(device="cpu")
    scene = port_synthetic.vio_scenario(TorchRig(specs=specs, T_SC=T_SC, intrinsics=intr), N_FRAMES)
    traj = scene.traj
    jspecs, jT_SC, jintr = euroc_stereo_rig()
    rig = NCameraSystem(specs=tuple(jspecs), T_SC=jT_SC, intrinsics=jintr)
    rig.compute_overlaps()
    dtype = jnp.float32 if DTYPE == "float32" else jnp.float64
    est = Estimator(rig, ImuParams.euroc(dtype=dtype), 5, 3, dtype=dtype)
    fe = Frontend(rig, FrontendConfig(detection_threshold=40.0, max_keypoints=N_KEYPOINTS))
    IdProvider.reset()
    trajectory, init_frame, keyframes, errors = [], None, 0, []
    t0 = time.perf_counter()
    for fi, (t, images) in enumerate(zip(scene.times, scene.images)):
        if trajectory:
            T_pred = trajectory[-1][1]
        else:
            ts, _gy, acc = port_synthetic.vio_imu_slice(traj, t - 1.0, t, t + port_synthetic.IMU_LEAD)
            T_pred = init_pose_from_imu(jnp.asarray(acc.mean(axis=0), dtype)) if len(ts) >= 2 else None
        frames = fe.detect_and_describe_multi(images, T_pred)
        mf = MultiFrame(id=IdProvider.new_id(), timestamp=t, frames=frames)
        last_t = est._last_state().timestamp if est.states else t
        ts, gy, acc = port_synthetic.vio_imu_slice(traj, min(last_t, t), t, t + port_synthetic.IMU_LEAD)
        if len(ts) < 2:
            continue
        sid = est.add_states(t, ts, gy, acc, as_keyframe=False, frame_id=mf.id, defer_fetch=True)
        est.multiframes[mf.id] = mf
        T_prop, sb_prop = est.last_prop_device()
        as_kf = fe.data_association_and_initialization(est, T_prop, mf, sb_prop=sb_prop)
        est.set_keyframe(sid, as_kf)
        est.optimize()
        est.apply_marginalization_strategy()
        if fe.is_initialized and init_frame is None:
            init_frame = fi
        keyframes += int(as_kf)
        T = est.get_T_WS(sid)
        trajectory.append((int(round(t * NS)), T))
        i = int(round(t * 200))
        errors.append(float(np.linalg.norm(np.asarray(T.r, np.float64) - traj.r[i])))
    seconds = time.perf_counter() - t0
    est_ts = np.asarray([ts for ts, _ in trajectory])
    est_p = np.stack([np.asarray(T.r, np.float64) for _, T in trajectory])
    ate = ate_rmse(est_ts, est_p, (traj.ts * NS).astype(np.int64), traj.r)
    print(json.dumps(dict(
        dtype=DTYPE, device="cpu", frames=N_FRAMES, frames_tracked=len(trajectory), ate_m=ate,
        landmarks=est.num_landmarks(), keyframes=keyframes, initialized_at_frame=init_frame,
        position_error_m=errors, seconds=seconds)), flush=True)


if __name__ == "__main__":
    main()
