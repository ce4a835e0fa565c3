"""Full-pipeline frames/s and ATE of the port (port of scripts/bench_pipeline.py).

Measures the whole per-frame path (detection, description, the fused
association round, RANSAC, stereo, add_states, optimize, marginalization)
through ThreadedVio in blocking mode, float32, on a rendered synthetic
world: the EuRoC stereo rig, trajectory seed 31 at motion scale 0.25, a
landmark cloud at 4-8 m (seed 32), frames 0.1 s apart. Every image is
rendered before the clock starts. The first `warmup` frames are skipped.

Then each captured per-frame program (detect, associate, propagate,
optimize, marginalize: utils.capture) is replayed on its captured inputs:
its outputs must equal, bit for bit, those of the call it captured; its
device ms a call is the summed kernel time of a few profiled replays
(utils.profiling) and its wall ms a call the host time of back-to-back
replays, dispatch included. The optimize program is replayed once more at
min_iterations, the real-time operating point. Off the card, the device ms
of a replay is its wall ms (the CPU runs the ops itself).

`value` is the steady wall frames/s a user sees. `device_fps_ceiling` is
1000 / (the five programs' device ms): a ceiling, the rate if the host cost
nothing, which no user sees while the card idles most of a frame.

    python -m okvis_tpu_torch.bench.bench_pipeline [n_frames] [--device cpu] [--config PATH] [--out PATH]
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from . import common

NS = 1_000_000_000
FRAME_DT = 0.1
WARMUP = 10
PROGRAMS = ("detect", "associate", "propagate", "optimize", "marginalize")
# blocking host<->device round trips of the processing loop (the frame's
# critical path); detect_fetch runs in the detection thread
PROC_SYNCS = ("associate_fetch", "optimize_fetch", "resolve_prop", "propagate_fetch", "ransac2d2d",
              "stereo_standalone", "lmq_fetch", "assoc_recovery")


def bench_params(max_keypoints: int, config: Optional[str] = None):
    """VioParameters (the EuRoC defaults, or read from `config`) with the
    bench's keypoints and detection threshold 15."""
    from ..config import VioParameters, read_config

    params = read_config(config) if config else VioParameters()
    params.optimization.max_num_keypoints = max_keypoints
    params.optimization.detection_threshold = 15.0
    return params


def euroc_rig(device, cameras: int = 2):
    """The EuRoC stereo rig (or its first camera) on `device`, overlaps computed."""
    from .. import kinematics as kin
    from ..cameras.ncamera import NCameraSystem
    from ..datasets.synthetic import euroc_stereo_rig

    specs, T_SC, intr = euroc_stereo_rig(device=device)
    rig = NCameraSystem(specs=tuple(specs[:cameras]), T_SC=kin.SE3(r=T_SC.r[:cameras], q=T_SC.q[:cameras]),
                        intrinsics=list(intr[:cameras]))
    rig.compute_overlaps()
    return rig


def bench_world(n_frames: int, n_world_landmarks: int):
    """scripts/bench_pipeline.py:80-85's world: (trajectory, landmarks)."""
    from ..datasets.synthetic import make_landmarks, simulate_trajectory

    traj = simulate_trajectory(duration=(n_frames + 2) * FRAME_DT, seed=31, motion_scale=0.25)
    return traj, make_landmarks(traj, n_world_landmarks, seed=32, radius=(4.0, 8.0))


def render_frame(rig_true, traj, lms, fi: int, nuisance: Optional[Callable] = None) -> list:
    """Frame `fi`'s images, each camera rendered on the CPU in float64 at the
    true pose (datasets.synthetic.render_world_image); `nuisance(img, fi,
    cam)` is applied to each in camera order."""
    from .. import kinematics as kin
    from ..datasets.synthetic import render_world_image

    cpu = lambda x: x.detach().cpu().double()  # noqa: E731
    i = int(round(fi * FRAME_DT * 200))
    T_WS = kin.SE3(r=torch.from_numpy(traj.r[i]), q=torch.from_numpy(traj.q[i]))
    images = []
    for c in range(rig_true.num_cameras):
        T_WC = kin.compose(T_WS, kin.SE3(r=cpu(rig_true.T_SC.r[c]), q=cpu(rig_true.T_SC.q[c])))
        img = render_world_image(rig_true.specs[c], cpu(rig_true.intrinsics[c]), T_WC, lms)
        images.append(img if nuisance is None else nuisance(img, fi, c))
    return images


def feed_frame(vio, traj, fi: int, images, imu_i: int, timeout: float = 300.0) -> tuple:
    """Frame `fi` (at fi * 0.1 s, timestamps in ns as utils.time.ns_from_sec
    rounds them) into `vio`: the IMU up to 25 ms past the frame, each
    camera's image, wait_idle. Returns (the next IMU index, host seconds
    from the first add_image to wait_idle's return)."""
    from ..utils.time import ns_from_sec

    t_ns = int(ns_from_sec(fi * FRAME_DT))
    while imu_i < len(traj.ts) and int(ns_from_sec(traj.ts[imu_i])) <= t_ns + 25_000_000:
        vio.add_imu_measurement(int(ns_from_sec(traj.ts[imu_i])), traj.gyro[imu_i], traj.acc[imu_i])
        imu_i += 1
    t0 = time.perf_counter()
    for c, img in enumerate(images):
        vio.add_image(t_ns, c, img)
    vio.wait_idle(timeout=timeout)
    return imu_i, time.perf_counter() - t0


def trajectory_ate(vio, traj) -> Optional[float]:
    """ATE (Umeyama-aligned, eval/ate.py) of the published trajectory."""
    from ..eval.ate import ate_rmse

    states = vio.trajectory
    if len(states) < 4:
        return None
    est_ts = np.asarray([s.timestamp_ns for s in states], np.int64)
    est_pos = np.stack([s.T_WS.r.cpu().numpy() for s in states])
    ate = ate_rmse(est_ts, est_pos, (traj.ts * NS).astype(np.int64), traj.r)
    return None if ate is None else float(ate)


def replay(fn, args, kw, expected, device, wall_reps: int, kernel_reps: int) -> dict:
    """One captured program replayed on its captured inputs: bitwise
    equality with the captured call's outputs, wall ms a call, device ms a
    call (kernel sum on the card, wall ms off it) and launches a call."""
    call = lambda: fn(*args, **kw)  # noqa: E731
    out = call()
    equal = None if expected is None else common.tree_equal(out, expected)
    wall = common.wall_ms(call, device, wall_reps)
    k = common.kernel_ms(call, device, kernel_reps)
    return dict(bitwise_equal=equal, wall_ms=wall, device_ms=wall if k is None else k["kernel_ms"],
                launches=None if k is None else k["launches"])


def host_stages(frames: int) -> dict:
    """Every `host:` Timing stage's total ms a frame since the last reset."""
    from ..utils.timing import Timing

    return {name: 1e3 * acc.total / frames for name, acc in sorted(Timing._timers.items())
            if name.startswith("host:")}


def run_pipeline_bench(n_frames: int = 35, max_keypoints: int = 200, n_world_landmarks: int = 260, device=None,
                       config: Optional[str] = None, warmup: int = WARMUP, wall_reps: int = 20,
                       kernel_reps: int = 3, dtype=torch.float32, verbose: bool = True) -> dict:
    """Run the bench; returns the result dict (main prints it as one JSON
    line). The `Timing` stages and `host_stage_ms_per_frame` cover the
    frames after the warm-up."""
    from ..pipeline import ThreadedVio
    from ..utils import capture, syncstats
    from ..utils.ids import IdProvider
    from ..utils.timing import Timing

    dev = common.resolve_device(device)
    params = bench_params(max_keypoints, config)
    traj, lms = bench_world(n_frames, n_world_landmarks)
    rig_cpu = euroc_rig("cpu")
    frames = [render_frame(rig_cpu, traj, lms, fi) for fi in range(n_frames)]
    if verbose:
        print(f"rendered {n_frames} stereo frames", flush=True)

    capture.enabled = True
    capture.reset()
    IdProvider.reset()
    Timing.reset()
    vio = ThreadedVio(params, rig=euroc_rig(dev), blocking=True, dtype=dtype, device=dev)
    try:
        frame_s, sync_deltas, imu_i = [], [], 0
        t_all = time.perf_counter()
        for fi in range(n_frames):
            if fi == warmup:
                Timing.reset()
            s0 = syncstats.snapshot()
            imu_i, dt = feed_frame(vio, traj, fi, frames[fi], imu_i)
            frame_s.append(dt)
            s1 = syncstats.snapshot()
            sync_deltas.append({k: s1.get(k, 0) - s0.get(k, 0) for k in s1})
        wall_s = time.perf_counter() - t_all
        table = vio.shutdown()
    finally:
        capture.enabled = False
    steady = frame_s[warmup:] or frame_s
    steady_frames = len(steady)
    stages = {name: dict(count=acc.count, mean_ms=1e3 * acc.mean, max_ms=1e3 * acc.max)
              for name, acc in sorted(Timing._timers.items()) if not name.startswith("host:")}
    host = host_stages(steady_frames)
    fps = 1.0 / float(np.mean(steady))
    ate = trajectory_ate(vio, traj)

    steady_syncs = sync_deltas[warmup:] or sync_deltas
    syncs = {t: float(np.mean([d.get(t, 0) for d in steady_syncs])) for t in PROC_SYNCS}
    detect_syncs = float(np.mean([d.get("detect_fetch", 0) for d in steady_syncs]))
    lat = np.asarray(vio.opt_latencies[warmup:] or vio.opt_latencies)

    progs, outs = capture.programs(), capture.outputs()
    replays = {}
    for tag in PROGRAMS:
        if tag in progs:
            fn, args, kw = progs[tag]
            replays[tag] = replay(fn, args, kw, outs.get(tag), dev, wall_reps, kernel_reps)
    rt = None
    if "optimize" in progs:
        _, (problem,), _ = progs["optimize"]
        fn_min = vio.estimator._optimize_fn_for_problem(problem, params.optimization.min_iterations)
        rt = replay(fn_min, (problem,), {}, None, dev, wall_reps, kernel_reps)
        rt["min_iterations"] = params.optimization.min_iterations
    dev_total = sum(r["device_ms"] for r in replays.values())
    rt_total = dev_total - replays["optimize"]["device_ms"] + rt["device_ms"] if rt else dev_total
    result = dict(
        metric="pipeline_frames_per_s", value=fps, unit="frames/s", vs_baseline=fps / 20.0, ate_m=ate,
        blocking_syncs_per_frame=sum(syncs.values()), frames=len(vio.trajectory), frames_fed=n_frames,
        device_ms_per_frame=dev_total, device_fps_ceiling=1e3 / dev_total if dev_total else None,
        device_ms_per_frame_rt=rt_total, device_fps_ceiling_rt=1e3 / rt_total if rt_total else None,
        ceiling_note="1000 / the five programs' device ms: the rate if the host cost nothing; not a rate a "
                     "user sees",
        device_time="summed kernel ms of profiled replays" if dev.type == "cuda" else "replay wall ms (CPU)",
        device=common.device_name(dev), dtype=str(dtype).split(".")[-1], keypoints=max_keypoints,
        world_landmarks=n_world_landmarks, warmup_frames=warmup,
        median_frame_ms=1e3 * float(np.median(steady)), max_frame_ms=1e3 * float(np.max(steady)),
        frame_ms=[1e3 * s for s in frame_s], wall_s=wall_s,
        opt_latency_ms=dict(p50=1e3 * float(np.percentile(lat, 50)), p99=1e3 * float(np.percentile(lat, 99)),
                            budget=1e3 * params.optimization.time_limit) if len(lat) else None,
        syncs_per_frame={k: v for k, v in syncs.items() if v}, detect_syncs_per_frame=detect_syncs,
        programs=replays, programs_captured=sorted(progs), optimize_min_iterations=rt,
        stages=stages, host_stage_ms_per_frame=host)
    if verbose:
        print(table)
        print("blocking syncs/frame (steady): processing loop "
              f"{result['blocking_syncs_per_frame']:.2f} {result['syncs_per_frame']}, detection thread "
              f"{detect_syncs:.2f}")
        if result["opt_latency_ms"]:
            print("optimize latency: p50 {p50:.1f} ms, p99 {p99:.1f} ms (budget {budget:.0f} ms)".format(
                **result["opt_latency_ms"]))
        parts = ", ".join(f"{k} {r['device_ms']:.3f} (wall {r['wall_ms']:.3f}, equal {r['bitwise_equal']})"
                          for k, r in replays.items())
        print(f"device ms/frame: {dev_total:.3f} ({parts}) -> ceiling {result['device_fps_ceiling']:.1f} "
              "frames/s")
        if rt:
            print(f"  at min_iterations={rt['min_iterations']} (optimize {rt['device_ms']:.3f} ms): "
                  f"{rt_total:.3f} ms/frame -> ceiling {result['device_fps_ceiling_rt']:.1f} frames/s")
        print(f"pipeline: {result['frames']}/{n_frames} frames, steady {fps:.3f} frames/s (median "
              f"{result['median_frame_ms']:.1f} ms/frame), total wall {wall_s:.1f} s, ATE {ate} m", flush=True)
    return result


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=35)
    ap.add_argument("--config", default=None, help="OKVIS-format YAML (default: VioParameters() in code)")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    common.emit(run_pipeline_bench(args.n_frames, device=args.device, config=args.config,
                                   warmup=min(WARMUP, args.n_frames // 2)), args.out)


if __name__ == "__main__":
    main()
