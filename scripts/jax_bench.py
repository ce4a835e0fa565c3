#!/usr/bin/env python3
"""The JAX package's float32 CPU runs of the worlds the port's bench tools
drive, at a given length: the readings chip_smoke.py's bench phase holds
the port to (JAX_BENCH there). A CPU run of the reference; its numbers are
not device metrics.

scripts/bench_pipeline.py and scripts/accuracy_proxy.py read the absent
reference YAML, so this script builds their parameters in code (the EuRoC
defaults of VioParameters, 200 keypoints a camera, threshold 15) and feeds
the JAX package's ThreadedVio in blocking mode as the port's tools feed
theirs (okvis_tpu_torch.bench.bench_pipeline.feed_frame's order: the IMU
up to 25 ms past each frame, the images, wait_idle; timestamps rounded to
the ns by utils.time.ns_from_sec). The frames are rendered by the port's
own code (okvis_tpu_torch.bench.bench_pipeline.render_frame, the scenario
generators of okvis_tpu_torch.bench.accuracy_proxy with their nuisance), so
both packages see the same images:

- pipeline N: the pipeline bench's world (seeds 31 and 32, motion 0.25,
  260 landmarks at 4-8 m) for N frames on the EuRoC rig;
- cell CONFIG SCENARIO N SEED: one accuracy-proxy cell (CONFIG stereo,
  mono or loopclosure) of N frames.

Prints one JSON line: frames tracked of fed, the ATE (Umeyama-aligned,
eval/ate.py), landmarks and keyframes at the end, loop events (loopclosure)
and wall seconds.

    JAX_PLATFORMS=cpu python scripts/jax_bench.py pipeline 35
    JAX_PLATFORMS=cpu python scripts/jax_bench.py cell stereo photometric 40 0

About 1 s a frame on a CPU, after compiling.
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

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
from okvis_tpu_torch.bench import accuracy_proxy as port_proxy  # noqa: E402
from okvis_tpu_torch.bench import bench_pipeline as port_bench  # noqa: E402

NS = 1_000_000_000
FRAME_DT = 0.1


def jax_rig(cameras: int):
    specs, T_SC, intr = euroc_stereo_rig()
    rig = NCameraSystem(specs=tuple(specs[:cameras]), T_SC=kin.SE3(r=T_SC.r[:cameras], q=T_SC.q[:cameras]),
                        intrinsics=list(intr[:cameras]))
    rig.compute_overlaps()
    return rig


def run(traj, lms, nuisance, n_frames: int, cameras: int = 2, loop_closure: bool = False) -> dict:
    params = VioParameters()
    params.optimization.max_num_keypoints = 200
    params.optimization.detection_threshold = 15.0
    params.posegraph.enabled = loop_closure
    rig_true = port_bench.euroc_rig("cpu", cameras)
    IdProvider.reset()
    vio = ThreadedVio(params, rig=jax_rig(cameras), blocking=True, dtype=jnp.float32)
    imu_i = 0
    t0 = time.perf_counter()
    for fi in range(n_frames):
        images = port_bench.render_frame(rig_true, traj, lms, fi, nuisance)
        t_ns = int(ns_from_sec(fi * FRAME_DT))
        while imu_i < len(traj.ts) and int(ns_from_sec(traj.ts[imu_i])) <= t_ns + 25_000_000:
            vio.add_imu_measurement(int(ns_from_sec(traj.ts[imu_i])), traj.gyro[imu_i], traj.acc[imu_i])
            imu_i += 1
        for c, img in enumerate(images):
            vio.add_image(t_ns, c, img)
        vio.wait_idle(timeout=600)
    vio.shutdown()
    seconds = time.perf_counter() - t0
    states = vio.trajectory
    est_ts = np.asarray([s.timestamp_ns for s in states], np.int64)
    est_p = np.stack([np.asarray(s.T_WS.r, np.float64) for s in states])
    ate = ate_rmse(est_ts, est_p, (traj.ts * NS).astype(np.int64), traj.r)
    pg = vio.posegraph
    return dict(dtype="float32", device="cpu", frames_fed=n_frames, frames_tracked=len(states),
                ate_m=None if ate is None else float(ate), landmarks=vio.estimator.num_landmarks(),
                keyframes=sum(s.is_keyframe for s in states),
                loop_events=None if pg is None else len(pg.loop_events),
                loops_accepted=None if pg is None else sum(e.accepted for e in pg.loop_events), seconds=seconds)


def main() -> None:
    what = sys.argv[1] if len(sys.argv) > 1 else "pipeline"
    if what == "pipeline":
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 35
        traj, lms = port_bench.bench_world(n, 260)
        out = dict(run=f"pipeline {n}", **run(traj, lms, None, n))
    elif what == "cell":
        config, scen, n, seed = sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
        if config not in ("stereo", "mono", "loopclosure"):
            sys.exit(f"configuration {config}: only stereo, mono and loopclosure are run here")
        traj, lms, nuisance = port_proxy.SCENARIOS[scen](n_frames=n, seed_offset=seed)
        fed = int(traj.ts[-1] / FRAME_DT) - 2
        out = dict(run=f"cell {config} {scen} {n} {seed}",
                   **run(traj, lms, nuisance, fed, 1 if config == "mono" else 2, config == "loopclosure"))
    else:
        sys.exit(f"usage: {sys.argv[0]} pipeline N | cell CONFIG SCENARIO N SEED")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
