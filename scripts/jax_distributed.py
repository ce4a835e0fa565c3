#!/usr/bin/env python3
"""The JAX package's ThreadedVio with the sliding-window BA sharded over a
4-device virtual CPU mesh (`distributed: devices: 4`), on the rendered
stereo frames that chip_smoke.py's distributed phase feeds the port's
sharded ThreadedVio on the card. A CPU run of the reference; its numbers
are not device metrics.

The frames are the first FRAMES of okvis_tpu_torch.datasets.synthetic.
vio_scenario's 20 (tests/test_vision_e2e.py::test_full_vision_tracking's
world, rendered on the CPU, so both packages see the same images); the
EuRoC stereo rig with overlaps; VioParameters built in code with the EuRoC
defaults, 400 keypoints a camera at threshold 40 and distributed_devices 4;
blocking mode; the IMU fed up to 25 ms past each frame, then both images,
then wait_idle, with timestamps rounded to the ns (utils.time.ns_from_sec),
as scripts/jax_threaded_vio.py feeds.

Prints one JSON line: the ATE (Umeyama-aligned, eval/ate.py), frames
tracked, landmarks and keyframes at the end, the frame after which tracking
was initialized, per-frame position errors, and wall seconds.

    JAX_PLATFORMS=cpu python scripts/jax_distributed.py float32

A few minutes on a CPU, most of them compiling.
"""

import json
import os
import sys
import time

DTYPE = sys.argv[1] if len(sys.argv) > 1 else "float32"
if DTYPE not in ("float32", "float64"):
    sys.exit(f"usage: {sys.argv[0]} float32|float64")
N_DEVICES = 4
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={N_DEVICES}").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", DTYPE == "float64")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from okvis_tpu.cameras import NCameraSystem  # noqa: E402
from okvis_tpu.config.parameters import VioParameters  # noqa: E402
from okvis_tpu.datasets.synthetic import euroc_stereo_rig  # noqa: E402
from okvis_tpu.eval.ate import ate_rmse  # noqa: E402
from okvis_tpu.pipeline import ThreadedVio  # noqa: E402
from okvis_tpu.utils.ids import IdProvider  # noqa: E402
from okvis_tpu.utils.time import ns_from_sec  # noqa: E402
from okvis_tpu_torch.cameras.ncamera import NCameraSystem as TorchRig  # noqa: E402
from okvis_tpu_torch.datasets import synthetic as port_synthetic  # noqa: E402

FRAMES = 12  # of the scenario's 20
N_KEYPOINTS = 400
NS = 1_000_000_000


def main() -> None:
    assert len(jax.devices()) == N_DEVICES, jax.devices()
    specs, T_SC, intr = port_synthetic.euroc_stereo_rig(device="cpu")
    scene = port_synthetic.vio_scenario(TorchRig(specs=specs, T_SC=T_SC, intrinsics=intr), 20)
    traj = scene.traj
    jspecs, jT_SC, jintr = euroc_stereo_rig()
    rig = NCameraSystem(specs=tuple(jspecs), T_SC=jT_SC, intrinsics=jintr)
    rig.compute_overlaps()
    params = VioParameters()
    params.optimization.max_num_keypoints = N_KEYPOINTS
    params.optimization.detection_threshold = 40.0
    params.optimization.distributed_devices = N_DEVICES
    IdProvider.reset()
    vio = ThreadedVio(params, rig=rig, blocking=True, dtype=jnp.float32 if DTYPE == "float32" else jnp.float64)
    assert vio.estimator._n_shards == N_DEVICES
    ts_ns = [int(ns_from_sec(t)) for t in traj.ts]
    imu_i, init_frame = 0, None
    t0 = time.perf_counter()
    for fi, (t, images) in enumerate(list(zip(scene.times, scene.images))[:FRAMES]):
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
    ate = ate_rmse(est_ts, est_p, (traj.ts * NS).astype(np.int64), traj.r)
    err = lambda t, r: float(np.linalg.norm(r - traj.r[int(round(t / NS * 200))]))  # noqa: E731
    print(json.dumps(dict(
        dtype=DTYPE, device="cpu", mesh=N_DEVICES, frames=FRAMES, frames_tracked=len(states), ate_m=ate,
        landmarks=vio.estimator.num_landmarks(), keyframes=sum(s.is_keyframe for s in states),
        initialized_at_frame=init_frame, position_error_m=[err(s.timestamp_ns, p) for s, p in zip(states, est_p)],
        seconds=seconds)), flush=True)


if __name__ == "__main__":
    main()
