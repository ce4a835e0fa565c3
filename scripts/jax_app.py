#!/usr/bin/env python3
"""The JAX package on the two parts of chip_smoke.py's app phase, on the
CPU in float32. A CPU run of the reference; its numbers are not device
metrics.

- revisit: the posegraph phase's revisiting world (okvis_tpu_torch.datasets.
  synthetic.revisit_world, the same numpy trajectory and landmarks) written
  by the JAX package's write_euroc_format at its EuRoC rig, then
  okvis_tpu.apps.run_euroc.run with a YAML written from the parameters
  chip_smoke.app_params builds (the posegraph runtime part's: 400
  keypoints, threshold 40, min_gap 2, the pose graph on), the rig with its
  overlaps, loop closure. Prints the app's outputs (frames, ATE, loop
  closures, pose-graph keyframes, the loop ATE), the loop events and each
  accepted loop edge against the VIO relative pose.
- textured: chip_smoke.APP_TEXTURED's flight over datasets.synthetic.
  noise_texture, rendered by the JAX package's render_textured_plane and fed
  to its ThreadedVio as chip_smoke.run_textured feeds the port's. Prints
  frames tracked, the ATE, landmarks and keyframes.

In float32 the JAX package runs its pose graph in float32 too (x64 off).

    JAX_PLATFORMS=cpu python scripts/jax_app.py revisit
    JAX_PLATFORMS=cpu python scripts/jax_app.py textured

One JSON line a part; a few minutes each on a CPU.
"""

import json
import os
import sys
import tempfile
import time

import jax

PART = sys.argv[1] if len(sys.argv) > 1 else "revisit"
if PART not in ("revisit", "textured"):
    sys.exit(f"usage: {sys.argv[0]} revisit|textured")
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as smoke  # noqa: E402
import okvis_tpu.datasets.euroc as jeuroc  # noqa: E402
from okvis_tpu import kinematics as kin  # noqa: E402
from okvis_tpu.cameras import NCameraSystem  # noqa: E402
from okvis_tpu.datasets import synthetic as jsyn  # noqa: E402
from okvis_tpu.utils.ids import IdProvider  # noqa: E402
from okvis_tpu_torch.config.yaml_writer import write_config  # noqa: E402
from okvis_tpu_torch.datasets import synthetic as port_synthetic  # noqa: E402


def jax_rig():
    specs, T_SC, intr = jsyn.euroc_stereo_rig()
    rig = NCameraSystem(specs=tuple(specs), T_SC=T_SC, intrinsics=intr)
    rig.compute_overlaps()
    return rig


def revisit() -> dict:
    from okvis_tpu.apps import run_euroc

    # read with PIL: the JAX package's native decoder builds into its own
    # package directory
    jeuroc._native_decode = False
    rig = jax_rig()
    n = smoke.POSEGRAPH_RUNTIME["frames"]
    traj, lms = port_synthetic.revisit_world(n, smoke.POSEGRAPH_RUNTIME["period"])
    recorded = {}
    base = run_euroc.ThreadedVio

    class Recorded(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            recorded["vio"] = self

    with tempfile.TemporaryDirectory() as tmp:
        mav0 = jsyn.write_euroc_format(tmp, traj, lms, rig, frame_dt=0.1, n_frames=n)
        write_config(smoke.app_params(smoke.modes_rig("runtime", "cpu")), f"{tmp}/app.yaml")
        IdProvider.reset()
        run_euroc.ThreadedVio = Recorded
        t0 = time.perf_counter()
        out = run_euroc.run(f"{tmp}/app.yaml", mav0, dtype=jnp.float32, trajectory_out=f"{tmp}/app.tum", rig=rig,
                            loop_closure=True)
        seconds = time.perf_counter() - t0
    out.pop("timing")
    mgr = recorded["vio"].posegraph
    return dict(out, events=[dict(vars(e)) for e in mgr.loop_events], loop_edges=smoke.loop_edge_errors(mgr),
                seconds=seconds)


def textured() -> dict:
    from okvis_tpu.config.parameters import VioParameters
    from okvis_tpu.eval.ate import ate_rmse
    from okvis_tpu.pipeline import ThreadedVio
    from okvis_tpu.utils.time import ns_from_sec

    cfg = smoke.APP_TEXTURED
    rig = jax_rig()
    texture = port_synthetic.noise_texture(cfg["texture_size"], cfg["texture_seed"])
    traj = port_synthetic.simulate_trajectory(duration=cfg["duration"], seed=cfg["traj_seed"],
                                              motion_scale=cfg["motion_scale"])
    flip = np.asarray([1.0, -1.0, -1.0])
    q_down = jnp.asarray([1.0, 0.0, 0.0, 0.0])
    params = VioParameters()
    params.optimization.max_num_keypoints = cfg["keypoints"]
    params.optimization.detection_threshold = cfg["threshold"]
    IdProvider.reset()
    vio = ThreadedVio(params, rig=rig, blocking=True, dtype=jnp.float32)
    ts_ns = [int(ns_from_sec(t)) for t in traj.ts]
    imu_i, gt = 0, []
    t0 = time.perf_counter()
    for fi in range(cfg["frames"]):
        t_ns = int(ns_from_sec(fi * 0.1))
        idx = int(round(fi * 0.1 * 200))
        while imu_i < len(ts_ns) and ts_ns[imu_i] <= t_ns + 25_000_000:
            vio.add_imu_measurement(ts_ns[imu_i], traj.gyro[imu_i] * flip, traj.acc[imu_i] * flip)
            imu_i += 1
        T_WS = kin.SE3(r=jnp.asarray(traj.r[idx] + np.asarray([0.0, 0.0, cfg["height"]])),
                       q=kin.quat_multiply(jnp.asarray(traj.q[idx]), q_down))
        gt.append((t_ns, np.asarray(T_WS.r, np.float64)))
        for cam in range(2):
            img = jsyn.render_textured_plane(rig.specs[cam], rig.intrinsics[cam], kin.compose(T_WS, rig.camera_T_SC(cam)),
                                             texture, plane_scale=cfg["plane_scale"])
            vio.add_image(t_ns, cam, img)
        vio.wait_idle(timeout=600)
    vio.shutdown()
    states = vio.trajectory
    est_ts = np.asarray([s.timestamp_ns for s in states], np.int64)
    est_p = np.stack([np.asarray(s.T_WS.r, np.float64) for s in states])
    return dict(frames=cfg["frames"], frames_tracked=len(states),
                ate_m=ate_rmse(est_ts, est_p, np.asarray([t for t, _ in gt], np.int64), np.stack([p for _, p in gt])),
                landmarks=vio.estimator.num_landmarks(), keyframes=sum(s.is_keyframe for s in states),
                seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    print(json.dumps(dict(part=PART, dtype="float32", device="cpu", **globals()[PART]())), flush=True)
