#!/usr/bin/env python3
"""The JAX package's pose-graph layer on the three parts of chip_smoke.py's
posegraph phase, on the CPU. A CPU run of the reference; its numbers are
not device metrics.

- pgo (float64): scripts/bench_posegraph.py's drifting circle with its loop
  edge at each size of chip_smoke.POSEGRAPH_PGO["nodes"] (built by
  okvis_tpu_torch.datasets.synthetic.circle_pose_graph, the same numpy
  draws), solved with solver "auto" and the bench's 8 LM iterations of 60
  PCG rounds; at compare_nodes also "dense" and "pcg" with 12 iterations
  and 300 PCG rounds. Prints the costs, iterations and the poses of every
  (n/8)-th node and the last.
- loop (float64): tests/test_posegraph.py::TestManagerEndToEnd's square
  (datasets.synthetic.square_loop_keyframes, numpy seed
  chip_smoke.POSEGRAPH_LOOP["seed"]) through a PoseGraphManager at the
  runtime's capacities (256 nodes, 512 edges, 400 keypoints a keyframe,
  16-word descriptors). Prints the loop events and the final keyframe's
  VIO, corrected and live-corrected errors and corrected position.
- runtime (float32, or float64): the rendered revisiting frames of
  chip_smoke.py's posegraph runtime part (chip_smoke.revisit_scene) through
  the JAX ThreadedVio (scripts/jax_threaded_vio.py's feed) with the runtime
  phase's parameters, posegraph.enabled and min_gap
  chip_smoke.POSEGRAPH_RUNTIME["min_gap"]. Prints keyframes, graph nodes,
  each query's best candidate and score, the loop events and each accepted
  loop edge's distance to the VIO relative pose. In float32 the JAX package
  runs its pose graph in float32 too (x64 off), as on a TPU.

    JAX_PLATFORMS=cpu python scripts/jax_posegraph.py pgo
    JAX_PLATFORMS=cpu python scripts/jax_posegraph.py loop
    JAX_PLATFORMS=cpu python scripts/jax_posegraph.py runtime float32

One JSON line a part; about 10 s, 10 s and 90 s on a CPU.
"""

import json
import os
import sys
import time

import jax

PART = sys.argv[1] if len(sys.argv) > 1 else "pgo"
DTYPE = sys.argv[2] if len(sys.argv) > 2 else ("float32" if PART == "runtime" else "float64")
if PART not in ("pgo", "loop", "runtime") or DTYPE not in ("float32", "float64"):
    sys.exit(f"usage: {sys.argv[0]} pgo|loop|runtime [float32|float64]")
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", DTYPE == "float64")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as smoke  # noqa: E402
from okvis_tpu.posegraph.graph import PoseGraph  # noqa: E402
from okvis_tpu.posegraph.manager import PoseGraphConfig, PoseGraphManager  # noqa: E402
from okvis_tpu_torch.datasets import synthetic as port_synthetic  # noqa: E402

NS = 1_000_000_000


def pgo() -> dict:
    cfg = smoke.POSEGRAPH_PGO
    out = {}
    for n in cfg["nodes"]:
        g = port_synthetic.fill_pose_graph(PoseGraph(n, 2 * n), port_synthetic.circle_pose_graph(n))
        t0 = time.perf_counter()
        res = g.optimize(max_iterations=cfg["max_iterations"], pcg_iters=cfg["pcg_iters"])
        out[str(n)] = dict(smoke.pgo_reading(res, n), seconds=time.perf_counter() - t0)
    n = cfg["compare_nodes"]
    for s in ("dense", "pcg"):
        g = port_synthetic.fill_pose_graph(PoseGraph(n, 2 * n), port_synthetic.circle_pose_graph(n))
        res = g.optimize(max_iterations=cfg["compare_iterations"], pcg_iters=cfg["compare_pcg_iters"], solver=s)
        out[f"{n}_{s}"] = smoke.pgo_reading(res, n)
    return out


def loop() -> dict:
    cfg = smoke.POSEGRAPH_LOOP
    kfs = port_synthetic.square_loop_keyframes(np.random.default_rng(cfg["seed"]), cfg["landmarks"], words=True)
    mgr = PoseGraphManager(PoseGraphConfig(
        min_gap=cfg["min_gap"], score_threshold=cfg["score_threshold"], min_inliers=cfg["min_inliers"],
        node_capacity=cfg["node_capacity"], edge_capacity=cfg["edge_capacity"], db_kp_capacity=cfg["db_kp_capacity"],
        desc_words=16, desc_dtype=np.uint32))
    k = cfg["landmarks"]
    t0 = time.perf_counter()
    for i, kf in enumerate(kfs):
        mgr.add_keyframe(i, i * 10**8, *kf["vio"], kf["descriptors"], np.ones(k, bool), kf["bearings"],
                         kf["landmarks_W"], np.ones(k, bool))
    return dict(smoke.loop_reading(mgr, kfs), seconds=time.perf_counter() - t0)


def runtime() -> dict:
    from okvis_tpu.cameras import NCameraSystem
    from okvis_tpu.config.parameters import VioParameters
    from okvis_tpu.datasets.synthetic import euroc_stereo_rig
    from okvis_tpu.pipeline import ThreadedVio
    from okvis_tpu.utils.ids import IdProvider
    from okvis_tpu.utils.time import ns_from_sec

    scene = smoke.revisit_scene()
    traj = scene.traj
    jspecs, jT_SC, jintr = euroc_stereo_rig()
    rig = NCameraSystem(specs=tuple(jspecs), T_SC=jT_SC, intrinsics=jintr)
    rig.compute_overlaps()
    params = VioParameters()
    params.optimization.max_num_keypoints = smoke.VIO_KEYPOINTS
    params.optimization.detection_threshold = 40.0
    params.posegraph.enabled = True
    params.posegraph.min_gap = smoke.POSEGRAPH_RUNTIME["min_gap"]
    IdProvider.reset()
    vio = ThreadedVio(params, rig=rig, blocking=True, dtype=jnp.float32 if DTYPE == "float32" else jnp.float64)
    queries = []
    query = vio.posegraph.db.query

    def recorded(*args, **kw):
        res = query(*args, **kw)
        queries.append(res[:2])
        return res

    vio.posegraph.db.query = recorded
    ts_ns = [int(ns_from_sec(t)) for t in traj.ts]
    imu_i = 0
    t0 = time.perf_counter()
    for t, images in zip(scene.times, scene.images):
        t_ns = int(ns_from_sec(t))
        while imu_i < len(ts_ns) and ts_ns[imu_i] <= t_ns + 25_000_000:
            vio.add_imu_measurement(ts_ns[imu_i], traj.gyro[imu_i], traj.acc[imu_i])
            imu_i += 1
        for c, image in enumerate(images):
            vio.add_image(t_ns, c, image)
        vio.wait_idle(timeout=600)
    vio.shutdown()
    mgr = vio.posegraph
    events = [dict(vars(e)) for e in mgr.loop_events]
    return dict(frames=len(scene.times), frames_tracked=len(vio.trajectory),
                keyframes=sum(s.is_keyframe for s in vio.trajectory), nodes=mgr.graph.n_nodes, events=len(events),
                accepted=sum(e["accepted"] for e in events), event_list=events, queries=queries,
                loop_edges=smoke.loop_edge_errors(mgr), seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    print(json.dumps(dict(part=PART, dtype=DTYPE, device="cpu", **globals()[PART]())), flush=True)
