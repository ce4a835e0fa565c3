"""EuRoC dataset CLI driver (port of okvis_tpu.apps.run_euroc).

    python -m okvis_tpu_torch.apps.run_euroc <config.yaml> <dataset>/mav0 [skip-sec]

Feeds all measurements in timestamp order to ThreadedVio in blocking mode,
writes the estimated trajectory in TUM format, and reports the ATE RMSE
against the EuRoC ground truth and the per-stage timing table; with
--loop-closure also the pose graph's keyframe trajectory (a `.loop` TUM
file), its loop closures and its ATE.

Beside the JAX package's driver:
- `dtype` is a torch dtype (--f64 for float64);
- `device` None means the CUDA card, and `run` raises without one;
  --device cpu (device="cpu") runs on the CPU;
- `config` is a YAML path or a VioParameters built in code (reading YAML
  needs PyYAML, which a machine may lack);
- --profile DIR writes a torch.profiler trace (DIR/trace.json) where the
  JAX driver writes a jax.profiler trace;
  it records every thread with the pipeline's tracing on, so the trace
  carries each frame's spans (stages, waits, blocking fetches);
- `run(decoder=)` passes a PNG decoder to EurocDataset (the CLI keeps
  "auto": the native loader where it builds and the image has its size,
  else datasets/png.py); the result's `decoder_used` counts the images
  each one read.
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import os
import sys
import time

import numpy as np
import torch

from ..config import read_config
from ..config.parameters import VioParameters
from ..datasets.euroc import EurocDataset, ImageEvent, ImuSample
from ..device import resolve_device
from ..eval.ate import ate_rmse, write_tum
from ..pipeline import ThreadedVio


def run(
    config,
    mav0_dir: str,
    skip_sec: float = 0.0,
    max_frames: int = 0,
    dtype: torch.dtype = torch.float32,
    trajectory_out: str = "trajectory.tum",
    rig=None,
    detection_threshold: float = None,
    max_keypoints: int = None,
    loop_closure: bool = False,
    pose_view: str = None,
    distributed_devices: int = 0,
    profile_dir: str = None,
    checkpoint_out: str = None,
    resume: str = None,
    device=None,
    decoder: str = "auto",
) -> dict:
    if not os.path.isdir(mav0_dir):
        raise SystemExit(f"error: dataset directory not found: {mav0_dir}")
    if isinstance(config, VioParameters):
        params = copy.deepcopy(config)
    elif not os.path.isfile(config):
        raise SystemExit(f"error: config file not found: {config}")
    else:
        params = read_config(config)
    dev = resolve_device(device)
    if detection_threshold is not None:
        params.optimization.detection_threshold = detection_threshold
    if max_keypoints is not None:
        params.optimization.max_num_keypoints = max_keypoints
    if loop_closure:
        params.posegraph.enabled = True
    if distributed_devices:
        params.optimization.distributed_devices = distributed_devices
    ds = EurocDataset(mav0_dir, num_cameras=len(params.cameras), skip_sec=skip_sec, decoder=decoder)
    vio = ThreadedVio(params, rig=rig, blocking=True, dtype=dtype, device=dev)
    if resume:
        # long-sequence resume: restore the estimator window, marginal prior,
        # keyframe keypoint tables and session epoch
        vio.load_checkpoint(resume)

    viewer = None
    if pose_view:
        from ..pipeline.pose_viewer import PoseViewer

        viewer = PoseViewer()
        vio.full_state_callback = viewer.publish_full_state_as_callback

    prof = None
    if profile_dir:
        # the Timing registry gives stage walls on the host; the profiler
        # gives each kernel's device time, and, recording every thread, the
        # pipeline's spans (ThreadedVio.set_tracing) on the threads that ran
        # them
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        vio.set_tracing(True)
        activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * (dev.type == "cuda")
        prof = profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))
        prof.__enter__()
    n_frames = 0
    t_start = time.perf_counter()
    frame_limit = max_frames or 10**9
    try:
        for m in ds.measurements():
            if isinstance(m, ImuSample):
                vio.add_imu_measurement(m.timestamp_ns, m.gyro, m.acc)
            elif isinstance(m, ImageEvent):
                vio.add_image(m.timestamp_ns, m.cam_idx, m.load())
                if m.cam_idx == 0:
                    n_frames += 1
                    if n_frames >= frame_limit:
                        break
        vio.wait_idle(timeout=600)
        if checkpoint_out:
            vio.save_checkpoint(checkpoint_out)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    wall = time.perf_counter() - t_start
    timing_table = vio.shutdown()

    est_ts = np.asarray([s.timestamp_ns for s in vio.trajectory])
    est_p = np.stack([s.T_WS.r.numpy() for s in vio.trajectory]) if vio.trajectory else np.zeros((0, 3))
    est_q = np.stack([s.T_WS.q.numpy() for s in vio.trajectory]) if vio.trajectory else np.zeros((0, 4))
    if trajectory_out and len(est_ts):
        write_tum(trajectory_out, est_ts, est_p, est_q)

    out = {
        "frames_processed": len(vio.trajectory),
        "frames_fed": n_frames,
        "wall_s": wall,
        "frames_per_s": len(vio.trajectory) / wall if wall > 0 else 0.0,
        "ate_rmse_m": None,
    }
    gt = ds.ground_truth()
    if gt is not None and len(est_ts) >= 3:
        gt_ts, gt_p, _ = gt
        out["ate_rmse_m"] = ate_rmse(est_ts, est_p, gt_ts, gt_p)
    if vio.posegraph is not None:
        # the graph holds the loop-consistent keyframe trajectory
        kf_traj = vio.posegraph.trajectory()
        out["loop_closures"] = sum(1 for e in vio.posegraph.loop_events if e.accepted)
        out["posegraph_keyframes"] = len(kf_traj)
        if kf_traj:
            kf_ts = np.asarray([t for _, t, _, _ in kf_traj])
            kf_p = np.stack([r for _, _, r, _ in kf_traj])
            kf_q = np.stack([q for _, _, _, q in kf_traj])
            if trajectory_out:
                write_tum(trajectory_out + ".loop", kf_ts, kf_p, kf_q)
            if gt is not None and len(kf_ts) >= 3:
                out["ate_rmse_loop_m"] = ate_rmse(kf_ts, kf_p, gt_ts, gt_p)
    if viewer is not None:
        if vio.posegraph is not None and vio.posegraph.trajectory():
            viewer.add_loop_corrected(np.stack([r for _, _, r, _ in vio.posegraph.trajectory()]))
        viewer.save(pose_view)
    out["decoder_used"] = dict(collections.Counter(ds.decoder_used.values()))
    out["timing"] = timing_table
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("mav0")
    ap.add_argument("skip_sec", nargs="?", type=float, default=0.0)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--trajectory-out", default="trajectory.tum")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    ap.add_argument("--loop-closure", action="store_true",
                    help="enable the pose-graph/loop-closure layer")
    ap.add_argument("--pose-view", default=None, metavar="OUT.png",
                    help="render the top-down trajectory view to a PNG "
                         "(headless PoseViewer analog)")
    ap.add_argument("--distributed", type=int, default=0, metavar="N",
                    help="shard the sliding-window BA over N devices (CPU shards with --device cpu)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace to DIR/trace.json")
    ap.add_argument("--checkpoint-out", default=None, metavar="CKPT",
                    help="save a resumable pipeline checkpoint at the end "
                         "of the run (writes CKPT and CKPT.est)")
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="resume from a checkpoint written by "
                         "--checkpoint-out (combine with skip_sec to "
                         "continue mid-sequence)")
    args = ap.parse_args(argv)
    out = run(
        args.config,
        args.mav0,
        args.skip_sec,
        max_frames=args.max_frames,
        dtype=torch.float64 if args.f64 else torch.float32,
        trajectory_out=args.trajectory_out,
        loop_closure=args.loop_closure,
        pose_view=args.pose_view,
        distributed_devices=args.distributed,
        profile_dir=args.profile,
        checkpoint_out=args.checkpoint_out,
        resume=args.resume,
        device=args.device,
    )
    timing = out.pop("timing")
    print(timing, file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
