#!/usr/bin/env python3
"""Drive the okvis_tpu_torch vision slice, back end, estimator, the
per-frame VIO loop, the runtime (ThreadedVio), its estimator modes, the
pose-graph layer, the EuRoC app, the batched and sharded BA and the bench
tools on one CUDA card and check them.

    python3 chip_smoke.py

1. builds the hand-written CUDA kernels from okvis_tpu_torch/csrc (nvcc)
   and prints each kernel's registers, spills and shared memory;
2. prints the card's name and power limit (nvidia-smi);
3. renders a synthetic EuRoC-like stereo sequence of N_FRAMES frames
   (2 x 752x480, radtan) of a 260-landmark cloud, then for every frame runs
   Frontend.detect_and_describe_multi (400 keypoints, threshold 40,
   gravity-aligned) and Frontend.match_stereo on the card, with the kernel
   launch counters zeroed just before and read just after;
4. checks the result against ground truth: valid keypoints per camera,
   stereo matches per frame, and the share of valid triangulations within
   10 % depth of their nearest true landmark;
5. profiles a few frames (device time by kernel, device busy share);
6. holds each kernel to its plain torch version on the card, at the main
   path's shapes: Harris raw bit for bit over the whole image and the same
   suppressed pattern; Hamming exactly, masked and unmasked, at the
   stereo pair (400 x 400), the association batch (8, 400, 400) with B
   broadcast, a database shape (400 x 3200) and a ragged (397 x 1001), one
   launch a call; the CUDA assignment to the CPU one; and the last frame's
   keypoints and descriptor bits to a CPU run of the same frame;
7. times each kernel, its plain version and the yardstick (Hamming: the
   ±1 float32 torch.matmul, torch.bmm for the batch, and the whole
   masked_distance_matrix call) with CUDA events, a one-element torch add as
   the floor of a launch, and the per-frame stages with the host clock;
8. builds the back end's window at the estimator's full width in float32 on
   the card (BACKEND_WINDOW: 9 states, 512 landmark slots, 2048
   observation slots, 8 IMU links), perturbs it (numpy seed 7), runs
   propagate, the 8 links' preintegration and optimize_window (LM and dogleg
   with Newton-Schulz, LM with Cholesky) with host syncs raising, and holds
   each to ground truth and to the port's float64 CPU run; then the
   estimator's marginalization of state 0 (PSD, and against float64);
9. runs evaluate and optimize (LM + Newton-Schulz) twice on the same inputs
   and requires bitwise equal normal equations, states and accept patterns
   (the assembly sums in a fixed order);
10. times each back-end stage (preintegrate, propagate, evaluate, optimize,
   marginalize): CUDA events, host wall clock, torch.profiler launches and
   busy share, host syncs per call. No TPU kernel lies on this path;
11. runs the Estimator's add_states / optimize / apply_marginalization_strategy
   loop over 39 frames of the long-run scenario (ESTIMATOR_SCENARIO) at its
   default window (S = 9, L = 512, O = 2048, K = 8, 10 iterations) in
   float32 on the card, for LM + Newton-Schulz (twice) and LM + Cholesky;
   prints every frame's capacity tier, holds each run to the gates of
   ESTIMATOR_GATES (bounded window, the last 10 frames' errors, the final
   window against the port's float64 CPU run of the same variant) and the
   two Newton-Schulz runs to bitwise equality, and prints one `estimator`
   line a variant (host ms per stage, launches, syncs, busy share, tiers).
   Neither hand kernel launches in this phase;
12. runs the vio phase: 20 rendered stereo frames of the scenario of
   tests/test_vision_e2e.py::test_full_vision_tracking through the
   runtime's blocking per-frame loop (detect_and_describe_multi, add_states
   with the fetch deferred, data_association_and_initialization, optimize,
   apply_marginalization_strategy) at 400 keypoints and the default window
   in float32, twice: the first run timed per stage and in VIO_SPANS and
   profiled over 5 frames, the second with every association round under
   set_sync_debug_mode("error"); holds the run to VIO_GATES (frames
   tracked, ATE against the truth and against the JAX package's float32
   CPU run, landmarks, keyframes and the frame where tracking starts
   against that run), both kernels on the path (Harris
   once a frame, Hamming at the (P·C, 400, 400) association shape), the
   Hamming kernel to its plain version at that shape, and the rerun to
   bitwise equality; prints the `vio` line;
13. runs the runtime phase: the same 20 frames through the port's
   ThreadedVio (VioParameters built in code: the EuRoC defaults, 400
   keypoints, threshold 40) in blocking mode in float32, fed as
   tests/test_vision_e2e.py feeds (the IMU up to 25 ms past a frame, both
   images, wait_idle; timestamps rounded to the ns), with a propagated-state callback, a
   transferred-landmarks callback and a state CSV file, twice: the first
   run profiled over RUNTIME_PROFILE_FRAMES and checkpointed after
   RUNTIME_CHECKPOINT_AFTER frames (save_checkpoint, load_checkpoint into a
   fresh ThreadedVio, the window restored exactly), the second timed;
   holds it to RUNTIME_GATES (every frame processed, frames tracked, ATE,
   landmarks, keyframes and first tracked frame against the JAX
   ThreadedVio's float32 CPU run, the propagated states, the state CSV),
   both kernels on the path and the rerun to bitwise equality; prints the
   `runtime_frames` and `runtime` lines (Timing stages, frame ms, optimize
   latencies, publishing ms a sample, syncs, busy share, the frame ms over
   the vio phase's);
14. runs the modes phase (MODES): the runtime phase's frames through the
   port's ThreadedVio with scale-space detection (detection_octaves = 2)
   and a detection mask, with per-state extrinsics from a camera-1
   calibration 5.4 mm off, and camera 0 alone on tests/test_vision_e2e.py
   :158's gentle-motion world (the first 40 of 60 frames), each once
   profiled with its own launch counts and once more over its first
   MODES_RERUN_FRAMES frames for bitwise equality (every frame's
   keypoint-to-landmark ids, the trajectory and the landmark table at that
   frame), the per-state run checkpointed and restored; holds each to
   MODES_GATES (the JAX tests' ATE bounds, the JAX package's float32 CPU
   run of the same frames, JAX_MODES, the calibration error falling), both
   kernels on every mode's path (Harris once an octave a frame, counted
   at each octave's shape from a record of every launch), the
   Harris kernel to its plain version at the three pyramid levels with the
   mask over the whole image and the Hamming kernel at the mono
   association batch; prints `modes_frames` and `modes` lines a mode and
   a `modes_kernels` line;
15. runs the posegraph phase (check_posegraph), the pose-graph layer in
   float64 in three parts: pgo, the drifting circle of
   scripts/bench_posegraph.py at 256 nodes (the dense Cholesky path) and
   1,024 (PCG), each solved twice for bitwise equality, timed and
   profiled, held to the JAX package's float64 CPU reading (JAX_POSEGRAPH)
   with its gauge node unchanged, and dense against PCG at 256 nodes;
   loop, tests/test_posegraph.py's square loop through a PoseGraphManager
   at the runtime's capacities (256 x 400 keyframe database, one Hamming
   launch at (400, 102,400) a query), run twice, the loop to keyframe 0
   accepted and the corrected error under 0.3 x the VIO error and near
   the JAX reading; runtime, 27 frames of a world the rig turns round and
   revisits through ThreadedVio with the pose graph on and again without
   it, the states of the two bitwise equal, at least one loop verified,
   accepted and called back, the loop events and accepted loops within
   POSEGRAPH_GATES of the JAX float32 CPU run and each loop edge near the
   VIO relative pose. Each part's kernel launches are counted around it,
   the pose-graph layer's Hamming launches by shape. Prints a `posegraph`
   line a part, and the Hamming kernel against its plain version at the
   database shape, timed beside the ±1 float32 torch.matmul
   (`posegraph_kernels`);
16. runs the app phase (check_app): revisit, the posegraph phase's
   revisiting world written in the EuRoC layout by the port's
   write_euroc_format (2 x 752x480, on the CPU in float64; its sha256 held
   to APP_DATASET_SHA256) and run through apps.run_euroc.run on the card in
   float32 with loop closure and the zlib+numpy PNG decoder, then again
   with the native decoder where g++ and libpng build it (its images held
   equal to the python decoder's), each run's kernel launches recorded by
   shape; held to APP_GATES (every frame processed, the ATE, loop closures
   and pose-graph keyframes against the JAX float32 CPU run JAX_APP, each
   loop edge near the VIO relative pose, the second run's TUM files byte
   for byte the first's), and each kernel to its plain version at every
   shape the app launched it at (`app_kernels`); textured,
   tests/test_vision_textured.py's flight over a texture made in code
   (APP_TEXTURED), rendered by the port's render_textured_plane and fed
   to ThreadedVio twice, its first run's kernel launches recorded by
   shape, held to the JAX test's bounds and the rerun's trajectory, and
   each kernel to its plain version at every shape that run launched it at
   (`app_textured_kernels`). Each part gates that its launches by shape
   add up to its launch counts. Prints an `app` line a part;
17. runs the distributed phase (check_distributed, DISTRIBUTED) in four
   parts: sharded, make_sharded_optimizer on the back-end window in
   float64 on one-card meshes of 1, 2, 4 and 8 shards and a 2 x 4
   ("host", "map") mesh, each against the card's optimize_window at
   tests/test_parallel.py's tolerances, and in float32 at 4 shards against
   OPTIMIZE_GATES, with the observations shard_problem shed (none allowed),
   a bitwise rerun, ms and launches a call; two_process, a 2 x 2 mesh
   across two processes joined by torch.distributed over gloo on the card
   (tests/torch_multiproc_worker.py, killed on a timeout) against the
   single-device solve; batched, optimize_windows_batched at B = 1, 4, 16
   copies of the window against each window's own solve (1e-9 in float64,
   OPTIMIZE_GATES in float32), ms a window and launches a call; runtime,
   the runtime phase's first 12 frames through ThreadedVio with the window
   sharded over 4 shards on the card, held to the JAX package's float32
   CPU run on a 4-device mesh (JAX_DISTRIBUTED), with a bitwise rerun of
   its first 6 frames, each kernel held to its plain version at every
   shape it launched at (`distributed_kernels`). Prints a `distributed`
   line a part; the sharded part's ms a call come from
   okvis_tpu_torch.bench.bench_scaling.measure;
18. runs the bench phase (check_bench, BENCH): the port's measurement
   tools (okvis_tpu_torch.bench) at sizes that fit: bench.py's run (the
   pipeline bench's 35 frames through ThreadedVio with its five captured
   programs replayed, each bitwise equal to the call it captured, the host
   table of that run, ba_bench), the deadline contract, the capacity tiers,
   profile_ba, the detect bench, one optimize of the 4x window, the
   pose-graph bench (its 1,024 x 400 database queried, the Hamming kernel
   held to its plain version at (400, 409,600)) and one accuracy-proxy
   cell through the tool's --cell subprocess; held to BENCH_GATES and the
   JAX package's float32 CPU readings (JAX_BENCH); the pipeline run's
   kernels held to their plain versions at every shape it launched them
   at. Prints one `bench` line.

Every launch count by shape comes from one recorder, kernel_shapes.

Prints the `kernels` JSON line (each kernel's `launches` from the runtime's
first run, the other paths' in `launches_by_path`; each app part's and the
sharded runtime's and the bench pipeline's launches by shape beside their
plain versions and the ±1 float32 product; the bench database's shape),
and as its last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero without the
ok line; so does a run without CUDA or without the okvis_tpu_torch package.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import logging
import multiprocessing
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import replace
from types import SimpleNamespace

import numpy as np

from okvis_tpu_torch.bench.common import tree_equal
from okvis_tpu_torch.utils.profiling import profile_call, profile_summary

# ground-truth floors, set from a CPU run of the same frames (PERF.md)
MIN_KEYPOINTS = 30  # valid keypoints per camera and frame (CPU run: >= 43)
MIN_MATCHES = 12  # stereo matches per frame (CPU run: >= 23)
MIN_DEPTH_SHARE = 0.85  # valid triangulations within 10 % depth (CPU run: 0.955)

N_FRAMES = 20  # frames of the smoke sequence

# The back end's window at the estimator's full width: S = 9 states, C = 2
# cameras, L = 512 landmark slots, O = 2048 observation slots, P = 32 IMU
# samples a link, K = 8 links, 2 + 2 priors, 10 LM iterations; D = 147.
BACKEND_WINDOW = dict(num_frames=9, frame_stride=20, n_landmarks=400, duration=2.0, seed=5,
                      cfg_kwargs=dict(max_landmarks=512, max_observations=2048, imu_samples=32,
                                      max_imu_links=8, max_iterations=10, min_iterations=3))
# float32 on the card against the port's float64 CPU run (PERF.md gives the
# gaps measured on the card and on the CPU): propagate in m and m/s;
# preintegrate and marginalize as max |card - float64| over max |float64|
# per field.
PROPAGATE_F64_TOL = 1e-4
PREINTEGRATE_TOL = 1e-4
# optimize, per variant: gates on the errors against ground truth (m, rad,
# speed/bias, final over perturbed cost) and the final poses' distance from
# the float64 CPU run of the same variant (m, rad). LM + Cholesky takes the
# reference gates (TestEstimator.cpp:229-236). The float32 Newton-Schulz
# solve is not backward stable once the damping is small: LM + Newton-Schulz
# lands at up to 0.014 rad and 0.039 speed/bias over 20 card runs (the
# atomics' summation order differs run to run), the JAX package's own
# float32 run at 0.006 rad and 0.057; dogleg + Newton-Schulz fails every
# undamped step in both packages (scripts/jax_float32_window.py), so it is
# held to a finite result below the perturbed cost.
INF = float("inf")
OPTIMIZE_GATES = dict(
    optimize=dict(gates=(0.1, 3e-2, 0.1, 0.1), f64=(0.05, 0.03)),
    optimize_cholesky=dict(gates=(0.1, 1e-2, 0.04, 0.1), f64=(0.01, 5e-3)),
    optimize_dogleg=dict(gates=(INF, INF, INF, 1.0), f64=None),
)
# b0 on the scale sqrt(H_ii c0) that bounds it: float32's eigenvalue cut
# (eps * D * lmax) drops directions of H that float64 keeps
MARG_TOL = dict(H=1e-3, b0=0.1, c0=1e-4)
# The evaluate of commit 7d30a3d at this window, with index_add assembly
# (its chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W; PERF.md), printed
# beside this run's line
INDEX_ADD_EVALUATE = dict(launches=1184, kernel_ms=1.766, host_ms=26.88)

# The estimator phase: tests/test_estimator.py's long run (trajectory seed 3,
# motion scale 0.6, 4 s) with 600 landmarks at 3-9 m (seed 4), 39 frames
# 0.1 s apart, every second a keyframe, pixel noise 0.6 (scenario seed 11);
# the Estimator's default window. scripts/jax_float32_estimator.py runs the
# JAX package on the same frames.
ESTIMATOR_SCENARIO = dict(duration=4.0, traj_seed=3, motion_scale=0.6, n_landmarks=600, lm_seed=4,
                          radius=(3.0, 9.0), n_frames=39, seed=11, pixel_noise=0.6)
# Gates per variant, written before the first card run: the last 10 frames'
# newest-state errors (m, rad) and the final window's poses against the
# port's float64 CPU run of the same variant (m, rad). LM + Cholesky takes
# the reference gates (tests/test_estimator.py:103-104). LM + Newton-Schulz
# takes about three times what the JAX package reaches in float32 on the CPU
# (scripts/jax_float32_estimator.py: 0.0161 m, 0.0026 rad; LM + Cholesky
# 0.0165 m, 0.0044 rad). Against float64: the port's float32 CPU runs end
# within 0.009 m and 3.5e-3 rad of it.
ESTIMATOR_GATES = dict(
    optimize=dict(last10=(0.05, 1e-2), f64=(0.03, 1e-2)),
    optimize_cholesky=dict(last10=(0.1, 2e-2), f64=(0.03, 1e-2)),
)
ESTIMATOR_PROFILE_FRAMES = (20, 25)  # frame ids [a, b) under torch.profiler

# The vio phase: tests/test_vision_e2e.py::test_full_vision_tracking's world
# (trajectory seed 31, motion scale 0.25, 260 landmarks at 4-8 m, seed 32),
# 20 rendered stereo frames 0.1 s apart from t = 0, the EuRoC rig with
# overlaps, 400 keypoints a camera at threshold 40, the Estimator's default
# window in float32, LM + Newton-Schulz.
VIO_FRAMES = 20
VIO_KEYPOINTS = 400
VIO_PROFILE_FRAMES = (10, 15)  # frame indices [a, b) under torch.profiler
# Calls timed inside a frame's stages (vio_instruments): the Estimator's
# preintegration of its IMU links (optimize and marginalization), and the
# matching stage's association round, fetch and recovery round
VIO_SPANS = ("preintegrate", "association_round", "association_fetch", "recovery_round")
# The JAX package on the same frames on the CPU (scripts/jax_vio_loop.py; a
# CPU run, not a device metric)
JAX_VIO = dict(
    float32=dict(ate_m=0.02046147277096787, frames_tracked=20, landmarks=129, keyframes=6, initialized_at_frame=2),
    float64=dict(ate_m=0.017614342691576457, frames_tracked=20, landmarks=201, keyframes=6, initialized_at_frame=2),
)
# Gates: at least 17 of 20 frames tracked, the JAX test's ATE bound
# (tests/test_vision_e2e.py:71) and more than 30 landmarks at the end
# (:73); held to the JAX float32 CPU run besides: an ATE no more than
# ate_margin_m above it, landmarks within landmarks_rel of its count, its
# keyframe count and the frame where tracking starts. The margins were set
# from three readings of 0.0205-0.0216 m ATE and 129-131 landmarks, all with
# 6 keyframes and tracking from frame 2: the JAX run above, the port's
# float32 run on the card and the port's float32 run on the CPU
# (run_vio(vio_scene(), dev="cpu")).
VIO_GATES = dict(frames_tracked=17, ate_m=0.15, ate_margin_m=0.003, landmarks=30, landmarks_rel=0.1)

# The runtime phase: the vio phase's 20 frames through the port's
# ThreadedVio (runtime_params: EuRoC defaults, 400 keypoints, threshold 40)
# in blocking mode on the card in float32, fed as tests/test_vision_e2e.py
# feeds, twice; the first run profiled over RUNTIME_PROFILE_FRAMES and
# checkpointed after RUNTIME_CHECKPOINT_AFTER frames.
RUNTIME_PROFILE_FRAMES = (10, 15)
RUNTIME_CHECKPOINT_AFTER = 10
RUNTIME_STAGES = ("1.x detectAndDescribe", "2.1 addStates", "2.4 matching", "3.1 optimization",
                  "3.2 marginalization", "3.3 posegraph")
# The JAX package's ThreadedVio on the same frames on the CPU
# (scripts/jax_threaded_vio.py; a CPU run, not a device metric)
JAX_RUNTIME = dict(
    float32=dict(ate_m=0.02046147277096787, frames_tracked=20, landmarks=129, keyframes=6, initialized_at_frame=2,
                 propagated=380, propagated_last60_error_m=0.030185673312975697),
    float64=dict(ate_m=0.017614342699681707, frames_tracked=20, landmarks=201, keyframes=6, initialized_at_frame=2,
                 propagated=380, propagated_last60_error_m=0.04909388003401767),
)
# Gates: VIO_GATES' (at least 17 of 20 frames tracked, ATE under the JAX
# test's bound and within 0.003 m of the JAX float32 CPU run, landmarks
# within 10 % of its count, its keyframes and its first tracked frame), and
# the median position error of the last 60 propagated states under
# tests/test_pipeline.py:229's 0.05 m
RUNTIME_GATES = dict(VIO_GATES, propagated_error_m=0.05)

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
# Operations a second by class, without FMA. The data sheet's 67 TFLOP/s in
# float32 counts an FMA as two: 128 lanes an SM and clock. Per SM and clock
# the CUDA C++ Programming Guide's throughput table (compute capability 9.0)
# gives 128 float32 adds or multiplies, 64 integer adds, XORs, compares and
# maxima, 16 population counts. An SM also issues at most 128 thread
# instructions a clock (4 schedulers x 32 lanes), whatever their class.
# The tensor cores' dense int8 rate is the data sheet's 1,979 TOP/s.
H100_OPS_PER_S = {
    "issue": 67e12 / 2,
    "f32": 67e12 / 2,
    "alu": 67e12 / 2 * 64 / 128,
    "popc": 67e12 / 2 * 16 / 128,
    "int8_mma": 1979e12,
}
# per pixel: Scharr 18, products 3, blur 2 x 63, Harris score 7 (f32);
# mask 1, 9x9 window max 16, suppression 1 (alu)
HARRIS_OPS_PER_PIXEL = {"f32": 154, "alu": 18}
# Two routes to a Hamming distance of 512 bits: 16 words of xor, popcount and
# add on the CUDA cores, or 512 ±1 int8 multiply-adds (2 operations each) on
# the tensor cores
HAMMING_ROUTES = ({"alu": 2 * 16, "popc": 16}, {"int8_mma": 2 * 512})


def route_seconds(ops: dict) -> float:
    """One route's operations over their rates: each class alone, and the
    CUDA cores' classes together over the issue rate."""
    core = sum(n for c, n in ops.items() if c != "int8_mma")
    return max([core / H100_OPS_PER_S["issue"]] + [n / H100_OPS_PER_S[c] for c, n in ops.items()])


def bound(n_bytes: float, *routes: dict) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the least time of the routes the card offers for the operations."""
    ops_s = min(route_seconds(r) for r in routes)
    bytes_s = n_bytes / H100_BYTES_PER_S
    return 1e3 * max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"


class SmokeError(RuntimeError):
    pass


def scenario(n_frames: int):
    """Trajectory, landmarks and frame sample indices of the smoke sequence
    (trajectory seed 71, motion scale 0.3, landmark seed 72, radius 4-8 m).
    Frames start at 0.6 s: before that the camera looks straight up and the
    gravity extraction angle is ill-conditioned."""
    from okvis_tpu_torch.datasets.synthetic import make_landmarks, simulate_trajectory

    t0, dt = 0.6, 0.1
    traj = simulate_trajectory(duration=t0 + dt * n_frames + 0.05, seed=71, motion_scale=0.3)
    lms = make_landmarks(traj, 260, seed=72, radius=(4.0, 8.0))
    idx = [int(round((t0 + dt * i) * 200)) for i in range(n_frames)]
    return traj, lms, idx


def build_frontend(device):
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig
    from okvis_tpu_torch.frontend.frontend import Frontend, FrontendConfig

    specs, T_SC, intr = euroc_stereo_rig(device=device)
    rig = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)
    rig.compute_overlaps()
    return Frontend(rig, FrontendConfig(detection_threshold=40.0, max_keypoints=400))


def render_frames(frontend, traj, lms, idx):
    import torch

    from okvis_tpu_torch import kinematics as kin
    from okvis_tpu_torch.datasets.synthetic import render_world_image

    rig = frontend.rig
    out = []
    for i in idx:
        T_WS = kin.SE3(
            r=torch.tensor(traj.r[i], dtype=rig.dtype, device=rig.device),
            q=torch.tensor(traj.q[i], dtype=rig.dtype, device=rig.device),
        )
        imgs = [
            render_world_image(rig.specs[c], rig.intrinsics[c],
                               kin.compose(T_WS, rig.camera_T_SC(c)), lms)
            for c in range(rig.num_cameras)
        ]
        out.append((T_WS, imgs))
    return out


def run_slice(frontend, frames, lms, sync):
    """Detect+describe and stereo for every frame; per-frame stats and times."""
    from okvis_tpu_torch import kinematics as kin
    from okvis_tpu_torch.frontend.frame import MultiFrame

    stats = []
    for fi, (T_WS, imgs) in enumerate(frames):
        sync()
        t0 = time.perf_counter()
        fds = frontend.detect_and_describe_multi(imgs, T_WS)
        sync()
        t1 = time.perf_counter()
        results = frontend.match_stereo(MultiFrame(fi, 0.1 * fi, fds), T_WS)
        sync()
        t2 = time.perf_counter()
        n_match, n_tri, n_close = 0, 0, 0
        for ca, _cb, assign, hp, valid, par, _ci in results:
            ok = valid & (assign >= 0) & ~par
            n_match += int((assign >= 0).sum())
            pts = hp[ok, :3] / hp[ok, 3:4]
            cen = kin.compose(T_WS, frontend.rig.camera_T_SC(ca)).r.cpu().numpy()
            nn = np.linalg.norm(pts[:, None, :] - lms[None], axis=-1).argmin(axis=1)
            d_true = np.linalg.norm(lms[nn] - cen, axis=1)
            rel = np.abs(np.linalg.norm(pts - cen, axis=1) - d_true) / d_true
            n_tri += int(ok.sum())
            n_close += int((rel < 0.1).sum())
        stats.append(dict(
            keypoints=[f.num_keypoints for f in fds], matches=n_match,
            triangulated=n_tri, within_10pct=n_close,
            detect_ms=1e3 * (t1 - t0), stereo_ms=1e3 * (t2 - t1),
        ))
    return stats, fds


def check_ground_truth(stats):
    kp_min = min(min(s["keypoints"]) for s in stats)
    match_min = min(s["matches"] for s in stats)
    share = sum(s["within_10pct"] for s in stats) / max(1, sum(s["triangulated"] for s in stats))
    summary = dict(frames=len(stats), min_keypoints=kp_min, min_matches=match_min,
                   triangulated=sum(s["triangulated"] for s in stats), depth_share=share)
    print("ground_truth", json.dumps(summary))
    if kp_min < MIN_KEYPOINTS or match_min < MIN_MATCHES or share < MIN_DEPTH_SHARE:
        raise SmokeError(f"ground-truth check failed: {summary}")
    return summary


def check_against_cpu(frames, fds_card):
    """The last frame's detect+describe on the CPU (plain Harris, CPU blur)
    against the card's: the same valid keypoints, and the share of
    descriptor bits that differ (the blur sums in another order)."""
    from okvis_tpu_torch import kinematics as kin

    T_WS, imgs = frames[-1]
    fds_cpu = build_frontend("cpu").detect_and_describe_multi(
        imgs, kin.SE3(r=T_WS.r.cpu(), q=T_WS.q.cpu()))
    flips = bits = 0
    for c, (fg, fc) in enumerate(zip(fds_card, fds_cpu)):
        mg, mc = fg.mask_np, fc.mask_np
        og = np.lexsort((fg.uv_np[mg][:, 1], fg.uv_np[mg][:, 0]))
        oc = np.lexsort((fc.uv_np[mc][:, 1], fc.uv_np[mc][:, 0]))
        if mg.sum() != mc.sum() or not np.allclose(fg.uv_np[mg][og], fc.uv_np[mc][oc], atol=1e-3):
            raise SmokeError(f"camera {c}: card and CPU keypoints differ")
        dg = fg.descriptors.cpu().numpy().view(np.uint32)[mg][og]
        dc = fc.descriptors.numpy().view(np.uint32)[mc][oc]
        flips += int(np.unpackbits((dg ^ dc).view(np.uint8)).sum())
        bits += dg.size * 32
    print("card_vs_cpu", json.dumps(dict(descriptor_bit_flips=flips, bits=bits, flip_rate=flips / bits)))
    if flips > 0.005 * bits:
        raise SmokeError(f"descriptor bits differ from the CPU run on {flips} of {bits}")


def profile_slice(frontend, frames, lms):
    """torch.profiler over a few frames of the slice: device time by kernel
    and the device's busy share of the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_slice(frontend, frames, lms, torch.cuda.synchronize)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print("profile", json.dumps(dict(
        frames=len(frames), wall_ms=wall_ms, device_ms=device_ms,
        device_busy_share=device_ms / wall_ms, kernel_launches=sum(e.count for e in kernels),
        top=[dict(kernel=e.key[:90], device_ms=e.self_device_time_total / 1e3, calls=e.count)
             for e in kernels[:12]],
    )))


def device_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median over `reps` of the device time of `inner` back-to-back calls,
    divided by `inner`. A sleep kernel queued first keeps the card busy
    while the host enqueues, so host overhead does not show."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def hamming_cases(fds, dev) -> dict:
    """(desc_a, desc_b, mask_a, mask_b) of each Hamming shape: the stereo
    pair of the last frame (400 x 400); the association's batch, P = 4
    sources x C = 2 cameras against one frame's B, broadcast (8, 400, 400);
    a database of 3200 (the frame's B and random descriptors); a ragged
    397 x 1001. Random parts from seed 5, masks 90 % true."""
    import torch

    da, db = fds[0].descriptors, fds[1].descriptors
    ma, mb = fds[0].keypoints.mask, fds[1].keypoints.mask
    k = db.shape[0]
    rng = np.random.default_rng(5)
    rand = lambda *s: torch.from_numpy(  # noqa: E731
        rng.integers(0, 2**32, s, dtype=np.uint32).view(np.int32)).to(dev)
    valid = lambda *s: torch.from_numpy(rng.uniform(size=s) < 0.9).to(dev)  # noqa: E731
    big, big_mask = rand(8 * k, 16), valid(8 * k)
    big[:k], big_mask[:k] = db, mb
    src, src_mask = rand(8, k, 16), valid(8, k)
    src[0], src_mask[0] = da, ma
    return {
        "400x400": (da, db, ma, mb),
        "8x400x400": (src, db[None], src_mask, mb[None]),
        "400x3200": (da, big, ma, big_mask),
        "397x1001": (da[:397], big[:1001], ma[:397], big_mask[:1001]),
    }


def check_kernels(images, fds):
    """Each kernel against its plain version on the card; returns the errors
    and the tensors the timings reuse."""
    import torch

    from okvis_tpu_torch.frontend import detection
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming import (
        hamming_matrix_mxu, masked_distance_matrix, masked_distance_matrix_plain,
        mutual_best_assignment)
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    dev = images.device
    C, H, W = images.shape
    border = 20
    inb = detection.border_mask(H, W, border, dev).expand(C, H, W).to(torch.float32).contiguous()
    raw_k, sup_k = harris_suppressed_cuda(images, inb)
    raw_p, sup_p = detection.harris_suppressed_plain(images, inb)
    torch.cuda.synchronize()
    # the two agree bit for bit over the whole image (csrc/harris_nms.cu)
    harris_err = float((raw_k - raw_p).abs().max())
    if not torch.equal(raw_k, raw_p):
        raise SmokeError(f"Harris raw differs from the plain version: max |d| {harris_err}")
    if not torch.equal(torch.isfinite(sup_k), torch.isfinite(sup_p)):
        raise SmokeError("Harris suppressed pattern differs from the plain version")

    # detect_keypoints through the kernel against the plain path on the card
    kps_k = detection.detect_keypoints(images, threshold=40.0, max_keypoints=400)
    kps_p = detection.select_keypoints(raw_p, sup_p, 40.0, 400, 4)
    for c in range(C):
        mk, mp = kps_k.mask[c], kps_p.mask[c]
        if int(mk.sum()) != int(mp.sum()):
            raise SmokeError(f"camera {c}: {int(mk.sum())} kernel keypoints vs {int(mp.sum())} plain")
        uk = kps_k.uv[c][mk].cpu().numpy()
        up = kps_p.uv[c][mp].cpu().numpy()
        uk = uk[np.lexsort((uk[:, 1], uk[:, 0]))]
        up = up[np.lexsort((up[:, 1], up[:, 0]))]
        if not np.allclose(uk, up, atol=1e-3):
            raise SmokeError(f"camera {c}: kernel and plain keypoints differ")

    # Hamming: every shape masked and unmasked, one launch a call
    ham = hamming_cases(fds, dev)
    ham_err = 0
    for name, args in ham.items():
        for masks in (args[2:], (None, None)):
            x = (*args[:2], *masks)
            before = hamming_matrix_cuda.launches
            dk = hamming_matrix_cuda(*x)
            if hamming_matrix_cuda.launches != before + 1:
                raise SmokeError(f"Hamming {name}: {hamming_matrix_cuda.launches - before} launches")
            dp = masked_distance_matrix_plain(*x)
            ham_err = max(ham_err, int((dk - dp).abs().max()))
            if not torch.equal(dk, dp):
                raise SmokeError(f"Hamming kernel differs from the plain version at {name} {tuple(dk.shape)}")
            if dk.dim() == 2 and masks[0] is None and not torch.equal(dk, hamming_matrix_mxu(*x[:2])):
                raise SmokeError(f"Hamming kernel differs from the ±1 matmul form at {name}")

    # assignment on CUDA equals the CPU result, with ties and the ratio test
    dist = masked_distance_matrix(*ham["400x400"])
    rng = np.random.default_rng(5)
    ties = torch.from_numpy(rng.integers(0, 6, (300, 280)).astype(np.int32)).to(dev)
    for d in (dist, ties):
        for ratio in (0.0, 0.8):
            g = mutual_best_assignment(d, 60, distance_ratio=ratio).cpu()
            h = mutual_best_assignment(d.cpu(), 60, distance_ratio=ratio)
            if not torch.equal(g, h):
                raise SmokeError(f"mutual_best_assignment on CUDA differs from CPU (ratio {ratio})")
    print("kernel_checks", json.dumps(dict(harris_raw_max_abs_err=harris_err, hamming_max_abs_err=ham_err)))
    return dict(inb=inb, ham=ham, harris_err=harris_err, ham_err=ham_err)


def time_kernels(images, chk, launches):
    import torch

    from okvis_tpu_torch.frontend import detection
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming import (
        masked_distance_matrix, masked_distance_matrix_plain, unpack_to_pm1)
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    C, H, W = images.shape
    inb = chk["inb"]
    px = C * H * W
    harris = dict(
        name="harris_nms", route="cuda", source="okvis_tpu_torch/csrc/harris_nms.cu",
        replaces="okvis_tpu/ops/detection_pallas.py:121",
        launches=launches["harris_nms"], max_abs_err=chk["harris_err"],
        ms=device_ms(lambda: harris_suppressed_cuda(images, inb)),
        plain_ms=device_ms(lambda: detection.harris_suppressed_plain(images, inb)),
        library_ms=None, shape=[C, H, W],
    )
    harris["bound_ms"], harris["bound_by"] = bound(
        16 * px, {c: n * px for c, n in HARRIS_OPS_PER_PIXEL.items()})

    def hamming_entry(a, b, ma, mb):
        g, na, nb = max(a.shape[0], b.shape[0]) if a.dim() == 3 else 1, a.shape[-2], b.shape[-2]
        n_bytes = (a.numel() + b.numel()) * 4 + ma.numel() + mb.numel() + g * na * nb * 4
        bound_ms, bound_by = bound(n_bytes, *({c: n * g * na * nb for c, n in r.items()}
                                              for r in HAMMING_ROUTES))
        va, vb = (unpack_to_pm1(t.reshape(-1, 16)).reshape(*t.shape[:-1], 512) for t in (a, b))
        library = ((lambda: torch.bmm(va, vb.expand(g, -1, -1).transpose(1, 2))) if a.dim() == 3
                   else (lambda: torch.matmul(va, vb.T)))
        return dict(
            shape=[g, na, nb],
            ms=device_ms(lambda: hamming_matrix_cuda(a, b, ma, mb)),
            unmasked_ms=device_ms(lambda: hamming_matrix_cuda(a, b)),
            call_ms=device_ms(lambda: masked_distance_matrix(a, b, ma, mb)),
            plain_ms=device_ms(lambda: masked_distance_matrix_plain(a, b, ma, mb)),
            library_ms=device_ms(library), bound_ms=bound_ms, bound_by=bound_by,
        )

    shapes = {name: hamming_entry(*args) for name, args in chk["ham"].items()}
    hamming = dict(
        name="hamming_xor_popcount", route="cuda", source="okvis_tpu_torch/csrc/hamming.cu",
        replaces="okvis_tpu/ops/hamming_pallas.py:40",
        launches=launches["hamming"], max_abs_err=chk["ham_err"], **shapes["400x400"],
    )
    for k in (harris, hamming):
        k["bound_us"] = 1e3 * k["bound_ms"]
    print("hamming_shapes", json.dumps(shapes))
    one = torch.zeros(1, device=images.device)
    print("launch_floor", json.dumps(dict(
        us=1e3 * device_ms(lambda: one.add_(1.0)), what="a one-element torch add, back to back")))
    return [harris, hamming]


def perturb_problem(problem, truth, rng, pose_scale=0.05, lm_scale=0.1):
    """Perturb every state but the prior-anchored first one, and the
    landmarks (the helper of tests/test_solver.py, in torch)."""
    import torch

    from okvis_tpu_torch import kinematics as kin

    S, n_lm = truth["r_WS"].shape[0], truth["n_landmarks"]
    st = problem.states
    t = lambda a: torch.as_tensor(a).to(st.r_WS)  # noqa: E731
    d = t(np.concatenate([np.zeros((1, 6)), rng.normal(0, pose_scale, (S - 1, 6))]))
    pose = kin.oplus(kin.SE3(r=st.r_WS[:S], q=st.q_WS[:S]), d)
    sb_noise = t(np.concatenate([np.zeros((1, 9)), rng.normal(0, pose_scale, (S - 1, 9))]))
    lm_noise = t(rng.normal(0, lm_scale, (n_lm, 3)))
    r_WS, q_WS, sb, hp = st.r_WS.clone(), st.q_WS.clone(), st.speed_and_bias.clone(), st.hp_W.clone()
    r_WS[:S], q_WS[:S] = pose.r, pose.q
    sb[:S] += sb_noise
    hp[:n_lm, :3] += lm_noise
    return problem._replace(states=st._replace(r_WS=r_WS, q_WS=q_WS, speed_and_bias=sb, hp_W=hp))


def build_window(dev, dtype):
    """The back end's window at the estimator's full width, perturbed with
    numpy seed 7: (cfg, imu_params, intrinsics, perturbed problem, truth)."""
    from okvis_tpu_torch.datasets.synthetic import build_ba_problem

    cfg, imu, intr, problem, truth = build_ba_problem(**BACKEND_WINDOW, device=dev, dtype=dtype)
    return cfg, imu, intr, perturb_problem(problem, truth, np.random.default_rng(7)), truth


def pose_errors(states, r_ref, q_ref) -> tuple:
    """(max position error, max orientation error in rad) of the states'
    poses against reference arrays."""
    import torch

    from okvis_tpu_torch import kinematics as kin

    S = r_ref.shape[0]
    r = states.r_WS[:S].detach().cpu().double()
    dq = kin.quat_multiply(kin.quat_conjugate(states.q_WS[:S].detach().cpu().double()),
                           torch.as_tensor(q_ref, dtype=torch.float64))
    ang = 2 * torch.atan2(torch.linalg.norm(dq[:, :3], dim=-1), dq[:, 3].abs())
    return float((r - torch.as_tensor(r_ref)).abs().max()), float(ang.max())


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def marg_masks(cfg, problem) -> tuple:
    """What the estimator's step eliminates when state 0 leaves the window:
    its 15 dense dims, and the landmarks only state 0 observes; the prior
    covers the other states' dims. Numpy masks from the observation table:
    (marg_dense, keep_dense, marg_lm)."""
    obs = problem.obs
    on = obs.mask.cpu().numpy()
    sidx, lidx = obs.state_idx.cpu().numpy()[on], obs.lm_idx.cpu().numpy()[on]
    seen_by_0, seen_by_other = np.zeros(cfg.max_landmarks, bool), np.zeros(cfg.max_landmarks, bool)
    seen_by_0[lidx[sidx == 0]] = True
    seen_by_other[lidx[sidx != 0]] = True
    d = np.arange(cfg.dense_dim)
    return d < 15, (d >= 15) & (d < cfg.num_states * 15), seen_by_0 & ~seen_by_other


def check_propagate(out, ref64, truth):
    """Link 0 propagated (mean only) against ground truth and float64."""
    import torch

    (T1, sb1), (T1_64, sb1_64) = out, ref64
    f1 = truth["frame_idx"][1]
    r, v = T1.r.cpu().double(), sb1[:3].cpu().double()
    prop = dict(gt_r=float((r - torch.as_tensor(truth["traj"].r[f1])).abs().max()),
                gt_v=float((v - torch.as_tensor(truth["traj"].v[f1])).abs().max()),
                f64_r=float((r - T1_64.r).abs().max()), f64_v=float((v - sb1_64[:3]).abs().max()))
    print("backend_propagate", json.dumps(prop))
    if max(prop["gt_r"], prop["gt_v"]) > 2e-3 or max(prop["f64_r"], prop["f64_v"]) > PROPAGATE_F64_TOL:
        raise SmokeError(f"propagate off: {prop}")


def check_preintegrate(pre, pre64):
    """The links preintegrated in full mode against float64, field by field."""
    K = pre.delta_t.shape[0]
    err = {name: rel_err(getattr(pre, name), getattr(pre64, name)[:K]) for name in pre64._fields}
    print("backend_preintegrate", json.dumps(err))
    if not max(err.values()) <= PREINTEGRATE_TOL:
        raise SmokeError(f"preintegrate differs from float64 beyond {PREINTEGRATE_TOL}: {err}")


def cfg_of(variant: str, cfg):
    """The window config of an optimize variant of OPTIMIZE_GATES."""
    return replace(cfg, dense_solver="cholesky" if variant.endswith("cholesky") else "newton",
                   algorithm="dogleg" if "dogleg" in variant else "lm")


def check_optimize(out, window, window64, truth):
    """Each variant against ground truth and against the float64 CPU run of
    the same variant, and the default run against a float32 run on the CPU
    of the same window (copied from the card); the gates and tolerances of
    OPTIMIZE_GATES."""
    import torch

    from okvis_tpu_torch.convert import problem_from_numpy, problem_to_numpy
    from okvis_tpu_torch.solver import evaluate, optimize_window

    cfg, imu, intr, problem = window
    S = cfg.num_states
    cost0 = float(evaluate(cfg, imu, intr, problem, problem.states).cost)
    cpu32 = (cfg, type(imu)(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in imu)),
             [i.cpu() for i in intr], problem_from_numpy(problem_to_numpy(problem), "cpu", torch.float32))
    opt = {}
    for name, (states, diag) in out.items():
        r_err, ang_err = pose_errors(states, truth["r_WS"], truth["q_WS"])
        sb_err = float((states.speed_and_bias[:S].cpu().double() - torch.as_tensor(truth["sb"])).abs().max())
        o = opt[name] = dict(position=r_err, orientation=ang_err, speed_bias=sb_err, cost0=cost0,
                             final_cost=float(diag.final_cost), accepted=diag.accepted.cpu().tolist())
        refs = [("f64", window64)] + ([("cpu_f32", cpu32)] if name == "optimize" else [])
        for key, (c, i, n, p) in refs:
            ref, _ = optimize_window(cfg_of(name, c), i, n, p)
            o[f"{key}_position"], o[f"{key}_orientation"] = pose_errors(
                states, ref.r_WS[:S].numpy(), ref.q_WS[:S].numpy())
    print("backend_optimize", json.dumps(opt))
    for name, o in opt.items():
        g = OPTIMIZE_GATES[name]
        errs = (o["position"], o["orientation"], o["speed_bias"], o["final_cost"] / cost0)
        if not (bool(torch.isfinite(out[name][0].r_WS).all()) and all(e < t for e, t in zip(errs, g["gates"]))):
            raise SmokeError(f"{name} misses its gates {g['gates']}: {o}")
        if g["f64"] and (o["f64_position"] > g["f64"][0] or o["f64_orientation"] > g["f64"][1]):
            raise SmokeError(f"{name} differs from the float64 CPU run beyond {g['f64']}: {o}")


def check_marginalize(window, window64, states):
    """The estimator's marginalization step at the optimized states:
    evaluate, then marginalize_system with c0_in = 2 cost. H symmetric and
    PSD, zero on the eliminated dims; H, b0, c0 on the kept block against
    float64 on the same states. Returns (eqs, marginalize call) for timing."""
    import torch

    from okvis_tpu_torch.estimator.marginalization import marginalize_system
    from okvis_tpu_torch.solver import evaluate

    cfg, imu, intr, problem = window
    marg_dense, keep_dense, marg_lm = marg_masks(cfg, problem)
    dev = problem.states.r_WS.device
    margs = tuple(torch.as_tensor(m, device=dev) for m in (marg_dense, keep_dense, marg_lm))
    eqs = evaluate(cfg, imu, intr, problem._replace(states=states), states)
    marg = marginalize_system(cfg, eqs, *margs, 2.0 * eqs.cost)
    cfg64, imu64, intr64, problem64 = window64
    states64 = type(states)(*(None if x is None else x.cpu().double() for x in states))
    eqs64 = evaluate(cfg64, imu64, intr64, problem64._replace(states=states64), states64)
    marg64 = marginalize_system(cfg64, eqs64, *(torch.as_tensor(m) for m in (marg_dense, keep_dense, marg_lm)),
                                2.0 * eqs64.cost)
    H = marg.H.cpu().double()
    w = torch.linalg.eigvalsh(H)
    kd = torch.as_tensor(keep_dense)
    checks = dict(
        eliminated_landmarks=int(marg_lm.sum()),
        asymmetry=float((H - H.T).abs().max() / H.abs().max()),
        least_over_largest_eig=float(w.min() / w.max()),
        eliminated_rows=float(H[torch.as_tensor(marg_dense)].abs().max() / H.abs().max()),
        H_rel=rel_err(marg.H[kd][:, kd], marg64.H[kd][:, kd]),
        # |b0_i| <= sqrt(H_ii c0) (b0 = -J^T e0): near the optimum b0 is a
        # small difference of large terms, so its error is read on that scale
        b0_scaled=float(((marg.b0.cpu().double() - marg64.b0)[kd]
                         / torch.sqrt(torch.diagonal(marg64.H)[kd] * marg64.c0)).abs().max()),
        c0_rel=rel_err(marg.c0, marg64.c0),
    )
    print("backend_marginalize", json.dumps(checks))
    if not (checks["asymmetry"] <= 1e-6 and checks["least_over_largest_eig"] >= -1e-6
            and checks["eliminated_rows"] <= 1e-6 and checks["H_rel"] <= MARG_TOL["H"]
            and checks["b0_scaled"] <= MARG_TOL["b0"] and checks["c0_rel"] <= MARG_TOL["c0"]):
        raise SmokeError(f"marginalization check failed: {checks}")
    return eqs, lambda: marginalize_system(cfg, eqs, *margs, 2.0 * eqs.cost)


def check_backend(dev, sync_free):
    """Build, propagate, preintegrate, optimize (three variants) and
    marginalize the full window in float32 on `dev`; hold each to ground
    truth and to the port's float64 CPU run. The calls of propagate,
    preintegrate and optimize run, after a warm-up, inside `sync_free()`, a
    context in which a host sync raises, with every input already on `dev`.
    Returns each stage's call for the timings, the window's normal
    equations, and its config."""
    import torch

    from okvis_tpu_torch import kinematics as kin
    from okvis_tpu_torch.imu.preintegration import preintegrate, propagate
    from okvis_tpu_torch.solver import evaluate, optimize_window

    cfg, imu, intr, problem, truth = build_window(dev, torch.float32)
    window64 = build_window("cpu", torch.float64)[:4]
    O = int(problem.obs.mask.sum())
    tf32 = torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
    print("backend_problem", json.dumps(dict(
        S=cfg.num_states, C=cfg.num_cameras, L=cfg.max_landmarks, O=cfg.max_observations,
        active_observations=O, K=cfg.max_imu_links, P=cfg.imu_samples, D=cfg.dense_dim,
        max_iterations=cfg.max_iterations, dtype="float32", tf32=tf32)))
    if (O, cfg.dense_dim, cfg.num_states) != (1250, 147, 9) or tf32:
        raise SmokeError(f"not the full window in float32: {O} observations, D = {cfg.dense_dim}, tf32 {tf32}")

    def inputs(d, dtype):
        """preintegrate's arguments for the K links, and propagate's for
        link 0 from the true state 0, already on `d`."""
        t = lambda a: torch.as_tensor(a).to(device=d, dtype=dtype)  # noqa: E731
        pre = tuple(t(v) for v in truth["imu_links"].values())
        T0 = kin.SE3(r=t(truth["r_WS"][0]), q=t(truth["q_WS"][0]))
        return pre, (T0, pre[5][0], *(a[0] for a in pre[:5]))

    (pre_in, prop_in), (pre_in64, prop_in64) = inputs(dev, torch.float32), inputs("cpu", torch.float64)
    stages = dict(
        propagate=lambda: propagate(imu, *prop_in),
        preintegrate=lambda: preintegrate(imu, *pre_in),
        **{name: (lambda c=cfg_of(name, cfg): optimize_window(c, imu, intr, problem))
           for name in OPTIMIZE_GATES},
    )
    for fn in stages.values():  # warm-up: allocator, cuBLAS and cuSOLVER handles
        fn()
    with sync_free():
        out = {name: fn() for name, fn in stages.items()}
    # back on the host from here: every read below may synchronise

    imu64 = window64[1]
    check_propagate(out["propagate"], propagate(imu64, *prop_in64), truth)
    check_preintegrate(out["preintegrate"], window64[3].imu_links.pre)
    check_optimize({name: out[name] for name in OPTIMIZE_GATES}, (cfg, imu, intr, problem), window64, truth)
    eqs, stages["marginalize"] = check_marginalize((cfg, imu, intr, problem), window64, out["optimize"][0])
    check_deterministic(cfg, imu, intr, problem, out["optimize"], sync_free)
    stages["evaluate"] = lambda: evaluate(cfg, imu, intr, problem, problem.states)
    return stages, eqs, cfg


def count_syncs(fn) -> int:
    """Host syncs in one call, counted from the warnings of
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def time_backend(stages, eqs, cfg) -> dict:
    """Per stage: device ms (CUDA events around back-to-back calls behind a
    sleep kernel), host wall ms (median of 20 calls, each ending in a sync),
    summed kernel time, launches and device busy share (torch.profiler),
    host syncs per call. Under optimize, the share of its kernel time that
    the 10 Newton-Schulz solves and the 11 evaluates take."""
    import torch

    from okvis_tpu_torch.bench.profile_ba import newton_schulz_call

    out = {}
    for name in ("preintegrate", "propagate", "evaluate", "optimize", "marginalize"):
        fn = stages[name]
        fn()
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
        row = dict(stage=name, device_ms=device_ms(fn, reps=5, inner=2), host_ms=statistics.median(host),
                   **profile_call(fn, top=8 if name == "optimize" else 0), syncs_per_call=count_syncs(fn))
        row["device_busy_share"] = row["kernel_ms"] / row["host_ms"]
        out[name] = row
    # the dense solve alone, on the window's Jacobi-scaled system: the
    # stage bench.profile_ba profiles
    newton = profile_call(newton_schulz_call(cfg, eqs))
    opt = out["optimize"]
    opt["newton_kernel_ms"], opt["newton_launches"] = newton["kernel_ms"], newton["launches"]
    opt["share_newton"] = cfg.max_iterations * newton["kernel_ms"] / opt["kernel_ms"]
    opt["share_evaluate"] = (cfg.max_iterations + 1) * out["evaluate"]["kernel_ms"] / opt["kernel_ms"]
    for row in out.values():
        print("backend", json.dumps(row))
    ev = out["evaluate"]
    print("backend_evaluate_assembly", json.dumps(dict(
        fixed_order={k: ev[k] for k in ("launches", "kernel_ms", "host_ms", "device_ms")},
        index_add_7d30a3d=INDEX_ADD_EVALUATE)))
    return out


def check_deterministic(cfg, imu, intr, problem, first_opt, sync_free) -> dict:
    """evaluate twice and LM + Newton-Schulz optimize once more on the same
    inputs, inside `sync_free()`: the normal equations, the states and the
    accept pattern must be bitwise equal to the first calls."""
    import torch

    from okvis_tpu_torch.solver import evaluate, optimize_window

    with sync_free():
        e1, e2 = (evaluate(cfg, imu, intr, problem, problem.states) for _ in range(2))
        states, diag = optimize_window(cfg_of("optimize", cfg), imu, intr, problem)
    states0, diag0 = first_opt
    same = dict(
        evaluate={name: torch.equal(a, b) for name, a, b in zip(e1._fields, e1, e2)},
        optimize={name: torch.equal(a, b) for name, a, b in zip(states._fields, states, states0) if a is not None},
        accepted=torch.equal(diag.accepted, diag0.accepted),
        cost_history=torch.equal(diag.cost_history, diag0.cost_history),
    )
    print("backend_determinism", json.dumps(same))
    if not (all(same["evaluate"].values()) and all(same["optimize"].values()) and same["accepted"]
            and same["cost_history"]):
        raise SmokeError(f"two runs on the same inputs differ: {same}")
    return same


def estimator_frames():
    """The estimator phase's frames and landmark initial positions
    (ESTIMATOR_SCENARIO), numpy, made on the CPU."""
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets import synthetic

    s = ESTIMATOR_SCENARIO
    traj = synthetic.simulate_trajectory(duration=s["duration"], seed=s["traj_seed"], motion_scale=s["motion_scale"])
    lms = synthetic.make_landmarks(traj, s["n_landmarks"], seed=s["lm_seed"], radius=s["radius"])
    specs, T_SC, intr = synthetic.euroc_stereo_rig(device="cpu")
    return synthetic.estimator_scenario(traj, lms, NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr),
                                        s["n_frames"], seed=s["seed"], pixel_noise=s["pixel_noise"])


def run_estimator(variant: str, dev: str, dtype, frames, init, profile: bool = False):
    """The loop a runtime drives, one frame at a time: add_states (+ the
    frame's landmarks and observations), optimize, marginalize, on `dev` in
    `dtype`. Per frame: host ms of each stage (each ends in a device sync),
    the optimize's capacity tier, syncstats counts, the newest state's
    errors, the window's size. With `profile`, the frames of
    ESTIMATOR_PROFILE_FRAMES run under torch.profiler (their host times are
    left out of the statistics). Returns (estimator, per-frame rows,
    profile summary or None)."""
    import torch
    from torch.profiler import ProfilerActivity

    from okvis_tpu_torch import kinematics as kin
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, feed_estimator_frame
    from okvis_tpu_torch.estimator import Estimator
    from okvis_tpu_torch.imu import ImuParams
    from okvis_tpu_torch.utils import syncstats

    specs, T_SC, intr = euroc_stereo_rig(device=dev)
    est = Estimator(NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr), ImuParams.euroc(dtype, dev), 5, 3,
                    device=dev, dtype=dtype)
    est.cfg = cfg_of(variant, est.cfg)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    rows, prof, summary = [], None, None
    a, b = ESTIMATOR_PROFILE_FRAMES
    for f in frames:
        if profile and f.frame_id == a:
            sync()
            # device activity only: the CPU operator events of ~200,000
            # launches take minutes to aggregate
            prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        syncstats.reset()
        sync()
        t0 = time.perf_counter()
        sid = feed_estimator_frame(est, f, init)
        sync()
        t1 = time.perf_counter()
        tier = est._select_tier()
        est.optimize()
        sync()
        t2 = time.perf_counter()
        est.apply_marginalization_strategy()
        sync()
        t3 = time.perf_counter()
        T = est.get_T_WS(sid)
        dq = kin.quat_multiply(kin.quat_conjugate(T.q), torch.from_numpy(f.q_WS))
        rows.append(dict(
            frame=f.frame_id, tier="full" if tier is None else f"{tier['L']}x{tier['O']}",
            add_ms=1e3 * (t1 - t0), optimize_ms=1e3 * (t2 - t1), marginalize_ms=1e3 * (t3 - t2),
            syncs=syncstats.snapshot(), profiled=prof is not None,
            position=float(np.linalg.norm(T.r.numpy() - f.r_WS)),
            orientation=float(2 * np.arccos(min(1.0, abs(float(dq[3]))))),
            frames=est.num_frames(), links=len(est.imu_links)))
        if prof is not None and f.frame_id == b - 1:
            wall_ms = 1e3 * (time.perf_counter() - t_prof)
            prof.__exit__(None, None, None)
            summary = profile_summary(prof, b - a, wall_ms)
            prof = None
    return est, rows, summary


def estimator_reference(variant: str) -> dict:
    """A worker process's job: the port's float64 CPU run of a variant over
    the estimator phase's frames, on half the host's cores; its final
    window."""
    import os

    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    frames, init = estimator_frames()
    return estimator_window(run_estimator(variant, "cpu", torch.float64, frames, init)[0])


def estimator_window(est) -> dict:
    """The final window as float64 numpy: slot tables and the prior."""
    import torch

    H = est.marg_H
    return dict(r_WS=est.r_WS.copy(), q_WS=est.q_WS.copy(), sb=est.sb.copy(), hp_W=est.hp_W.copy(),
                marg_H=H.detach().cpu().double().numpy() if isinstance(H, torch.Tensor) else np.array(H),
                slots=sorted(s.slot for s in est.states.values()))


def estimator_line(variant: str, rows, summary) -> dict:
    """The `estimator` JSON line of a variant: host ms per stage (median,
    max) after two warm-up frames and outside the profiled frames, syncs a
    frame by counter, the profiled frames' launches and busy share, the
    tiers."""
    timed = [r for r in rows[2:] if not r["profiled"]]
    counters = sorted({k for r in rows[2:] for k in r["syncs"]})
    line = dict(variant=variant, frames=len(rows), timed_frames=len(timed))
    for key in ("add_ms", "optimize_ms", "marginalize_ms"):
        vals = [r[key] for r in timed]
        line[key] = dict(median=statistics.median(vals), max=max(vals))
    line["frame_ms_median"] = statistics.median(r["add_ms"] + r["optimize_ms"] + r["marginalize_ms"] for r in timed)
    line["syncs_per_frame"] = {k: sum(r["syncs"].get(k, 0) for r in rows[2:]) / len(rows[2:]) for k in counters}
    line["profile"] = summary
    line["tiers"] = [r["tier"] for r in rows]
    line["last10_position"] = max(r["position"] for r in rows[-10:])
    line["last10_orientation"] = max(r["orientation"] for r in rows[-10:])
    return line


def check_estimator() -> dict:
    """The estimator phase (ESTIMATOR_SCENARIO): each variant on the card in
    float32 and on the CPU in float64; gates of ESTIMATOR_GATES; the two
    card runs of LM + Newton-Schulz bitwise equal; at least one frame at the
    full (512, 2048) tier and one at a reduced tier; neither hand kernel
    launched."""
    import torch

    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    t0 = time.perf_counter()
    frames, init = estimator_frames()
    print(f"estimator_scene_seconds {time.perf_counter() - t0:.2f}")
    harris_suppressed_cuda.launches = 0
    hamming_matrix_cuda.launches = 0
    runs, seconds = {}, {}
    # The float64 CPU references run in worker processes while the card
    # repeats LM + Newton-Schulz (a run whose times are not reported); the
    # timed card runs have the host to themselves.
    t0 = time.perf_counter()
    runs["optimize"] = run_estimator("optimize", "cuda", torch.float32, frames, init, profile=True)
    seconds["optimize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=len(ESTIMATOR_GATES), mp_context=multiprocessing.get_context("spawn")) as pool:
        refs = {v: pool.submit(estimator_reference, v) for v in ESTIMATOR_GATES}
        rerun = estimator_window(run_estimator("optimize", "cuda", torch.float32, frames, init)[0])
        refs = {v: f.result() for v, f in refs.items()}
    print(f"estimator_reference_seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    runs["optimize_cholesky"] = run_estimator("optimize_cholesky", "cuda", torch.float32, frames, init, profile=True)
    seconds["optimize_cholesky"] = time.perf_counter() - t0
    for variant, gates in ESTIMATOR_GATES.items():
        est, rows, summary = runs[variant]
        print("estimator_frames", json.dumps(dict(variant=variant, frames=[
            {k: r[k] for k in ("frame", "tier", "frames", "links", "position", "orientation")} for r in rows])))
        line = estimator_line(variant, rows, summary)
        line["seconds"] = seconds[variant]
        win, ref = estimator_window(est), refs[variant]
        if not isinstance(est.marg_H, torch.Tensor) or est.marg_H.device.type != "cuda":
            raise SmokeError(f"{variant}: the marginal prior left the card")
        if variant == "optimize":  # the same variant again: bit for bit
            line["bitwise_equal_rerun"] = {k: bool(np.array_equal(win[k], rerun[k])) for k in win}
        sl = win["slots"]
        line["f64_position"], line["f64_orientation"] = pose_errors(
            SimpleNamespace(r_WS=torch.from_numpy(win["r_WS"][sl]), q_WS=torch.from_numpy(win["q_WS"][sl])),
            ref["r_WS"][ref["slots"]], ref["q_WS"][ref["slots"]])
        print("estimator", json.dumps(line))
        bounded = all(r["frames"] <= 9 and r["links"] <= 8 for r in rows)
        tiers = set(line["tiers"])
        if not (bounded and rows[-1]["frames"] == 8 and est.marg_valid and len(rows) == len(frames)):
            raise SmokeError(f"{variant}: the window is not bounded as the reference's: {rows[-1]}")
        if "full" not in tiers or len(tiers) < 2:
            raise SmokeError(f"{variant}: tiers {sorted(tiers)}, not the full one and a reduced one")
        if not (line["last10_position"] < gates["last10"][0] and line["last10_orientation"] < gates["last10"][1]):
            raise SmokeError(f"{variant} misses its gates {gates['last10']}: {line}")
        if not (line["f64_position"] <= gates["f64"][0] and line["f64_orientation"] <= gates["f64"][1]):
            raise SmokeError(f"{variant} differs from the float64 CPU run beyond {gates['f64']}: {line}")
        if "bitwise_equal_rerun" in line and not all(line["bitwise_equal_rerun"].values()):
            raise SmokeError(f"two card runs of {variant} differ: {line['bitwise_equal_rerun']}")
    launches = dict(harris_nms=harris_suppressed_cuda.launches, hamming=hamming_matrix_cuda.launches)
    print("estimator_kernel_launches", json.dumps(launches))
    return launches


# ---------------------------------------------------------------------------
# the vio phase: detect -> add_states -> associate -> optimize -> marginalize
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def vio_scene():
    """The vio phase's world (datasets.synthetic.vio_scenario: the scenario
    of tests/test_vision_e2e.py::test_full_vision_tracking), rendered on the
    CPU once a process (every phase reads it, none writes it)."""
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, vio_scenario

    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    return vio_scenario(NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr), VIO_FRAMES)


def revisit_scene():
    """The posegraph phase's runtime world (datasets.synthetic.
    revisit_scenario at POSEGRAPH_RUNTIME's frames and period), rendered on
    the CPU."""
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, revisit_scenario

    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    return revisit_scenario(NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr), POSEGRAPH_RUNTIME["frames"],
                            POSEGRAPH_RUNTIME["period"])


@contextlib.contextmanager
def vio_instruments(est, sync, sync_check: bool):
    """Wrap the association programs and the estimator's preintegration and
    fetch for the length of a run: the shape of every Hamming call they make
    (the recovery round's tagged), the arguments of the last (P·C, K, K)
    call and of the last call of each program, and, with `sync_check`, every
    associate_multicam call inside set_sync_debug_mode("error"). Unless
    `sync_check`, each of them also adds its host ms, waited for on the card
    (`sync` before and after), to `log.ms` under VIO_SPANS' name."""
    import torch

    from okvis_tpu_torch.frontend import kernels

    log = SimpleNamespace(shapes=[], assoc_args=None, rounds=0, in_recovery=False, calls={},
                          ms=dict.fromkeys(VIO_SPANS, 0.0))

    def timed(name, fn):
        if sync_check:
            return fn

        def wrapper(*args, **kw):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                sync()
                log.ms[name] += 1e3 * (time.perf_counter() - t0)
        return wrapper
    orig_mdm, orig_assoc, orig_rec, orig_2d2d = (kernels.masked_distance_matrix, kernels.associate_multicam,
                                                 kernels.gated_match_pairs, kernels.ransac_2d2d_px)

    def mdm(*args):
        out = orig_mdm(*args)
        log.shapes.append(("recovery" if log.in_recovery else "association" if out.dim() == 3 else "stereo",
                           tuple(out.shape)))
        if out.dim() == 3 and not log.in_recovery:
            log.assoc_args = args
        return out

    def assoc(*args, **kw):
        log.rounds += 1
        log.calls["associate_multicam"] = (orig_assoc, args, kw)
        if not sync_check:
            return orig_assoc(*args, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig_assoc(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def bootstrap(*args, **kw):
        log.calls["ransac_2d2d_px"] = (orig_2d2d, args, kw)
        return orig_2d2d(*args, **kw)

    def recovery(*args, **kw):
        log.calls["gated_match_pairs"] = (orig_rec, args, kw)
        log.in_recovery = True
        try:
            return orig_rec(*args, **kw)
        finally:
            log.in_recovery = False

    names = ("masked_distance_matrix", "associate_multicam", "gated_match_pairs", "ransac_2d2d_px")
    wrapped = (mdm, timed("association_round", assoc), timed("recovery_round", recovery), bootstrap)
    for name, fn in zip(names, wrapped):
        setattr(kernels, name, fn)
    est._preintegrate_links = timed("preintegrate", est._preintegrate_links)
    est.fetch_with_pending = timed("association_fetch", est.fetch_with_pending)
    try:
        yield log
    finally:
        for name, fn in zip(names, (orig_mdm, orig_assoc, orig_rec, orig_2d2d)):
            setattr(kernels, name, fn)
        del est._preintegrate_links, est.fetch_with_pending


def run_vio(scene, dev: str = "cuda", profile: bool = False, sync_check: bool = False):
    """The runtime's blocking per-frame path (pipeline/threaded_vio.py's
    frame consumer and processing loop, without threads or queues) on the
    card in float32: the predicted pose (before the first state, the IMU's
    gravity), detect_and_describe_multi, add_states with the fetch
    deferred, the multiframe, last_prop_device,
    data_association_and_initialization, set_keyframe, optimize,
    apply_marginalization_strategy. Each stage ends in a device sync for its
    host time; the spans of vio_instruments are timed inside the stages.
    With `profile`, the frames of VIO_PROFILE_FRAMES run under
    torch.profiler and are left out of the time statistics. Returns
    (estimator, frontend, per-frame rows, trajectory, profile summary,
    instrument log)."""
    import torch
    from torch.profiler import ProfilerActivity

    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.synthetic import IMU_LEAD, euroc_stereo_rig, vio_imu_slice
    from okvis_tpu_torch.estimator import Estimator
    from okvis_tpu_torch.frontend.frame import MultiFrame
    from okvis_tpu_torch.frontend.frontend import Frontend, FrontendConfig
    from okvis_tpu_torch.imu import ImuParams
    from okvis_tpu_torch.imu.preintegration import init_pose_from_imu
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda
    from okvis_tpu_torch.utils import syncstats
    from okvis_tpu_torch.utils.ids import IdProvider

    dtype = torch.float32
    specs, T_SC, intr = euroc_stereo_rig(device=dev)
    rig = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)
    rig.compute_overlaps()
    IdProvider.reset()
    est = Estimator(rig, ImuParams.euroc(dtype, dev), 5, 3, device=dev, dtype=dtype)
    fe = Frontend(rig, FrontendConfig(detection_threshold=40.0, max_keypoints=VIO_KEYPOINTS))
    traj = scene.traj
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    rows, trajectory, summary, prof = [], [], None, None
    a, b = VIO_PROFILE_FRAMES
    with vio_instruments(est, sync, sync_check) as log:
        for fi, (t, images) in enumerate(zip(scene.times, scene.images)):
            if profile and fi == a:
                sync()
                prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
                t_prof = time.perf_counter()
            syncstats.reset()
            n_shapes, harris0, ham0 = len(log.shapes), harris_suppressed_cuda.launches, hamming_matrix_cuda.launches
            spans0 = dict(log.ms)
            sync()
            t0 = time.perf_counter()
            if trajectory:
                T_pred = trajectory[-1][2]
            else:
                ts, _gy, acc = vio_imu_slice(traj, t - 1.0, t, t + IMU_LEAD)
                T_pred = init_pose_from_imu(torch.tensor(acc.mean(axis=0), dtype=dtype, device=dev))
            frames = fe.detect_and_describe_multi(images, T_pred)
            sync()
            t1 = time.perf_counter()
            mf = MultiFrame(id=IdProvider.new_id(), timestamp=t, frames=frames)
            last_t = est._last_state().timestamp if est.states else t
            ts, gy, acc = vio_imu_slice(traj, min(last_t, t), t, t + IMU_LEAD)
            if len(ts) < 2:
                continue
            sid = est.add_states(t, ts, gy, acc, as_keyframe=False, frame_id=mf.id, defer_fetch=True)
            est.multiframes[mf.id] = mf
            sync()
            t2 = time.perf_counter()
            T_prop, sb_prop = est.last_prop_device()
            as_kf = fe.data_association_and_initialization(est, T_prop, mf, sb_prop=sb_prop)
            est.set_keyframe(sid, as_kf)
            sync()
            t3 = time.perf_counter()
            est.optimize()
            sync()
            t4 = time.perf_counter()
            est.apply_marginalization_strategy()
            sync()
            t5 = time.perf_counter()
            T = est.get_T_WS(sid)
            trajectory.append((t, sid, T))
            shapes = [sh for kind, sh in log.shapes[n_shapes:] if kind == "association"]
            i = int(round(t * 200))
            rows.append(dict(
                frame=fi, detect_ms=1e3 * (t1 - t0), add_ms=1e3 * (t2 - t1), matching_ms=1e3 * (t3 - t2),
                optimize_ms=1e3 * (t4 - t3), marginalize_ms=1e3 * (t5 - t4), frame_ms=1e3 * (t5 - t0),
                syncs=syncstats.snapshot(), profiled=prof is not None, keyframe=bool(as_kf),
                spans_ms={k: log.ms[k] - spans0[k] for k in VIO_SPANS}, initialized=fe.is_initialized, harris=harris_suppressed_cuda.launches - harris0,
                hamming=hamming_matrix_cuda.launches - ham0, hamming_association=len(shapes),
                association_shapes=sorted(set(shapes)),
                keypoints=[f.num_keypoints for f in frames],
                bound=[int((f.landmark_ids != 0).sum()) for f in mf.frames],
                landmarks=est.num_landmarks(), position=float(np.linalg.norm(T.r.numpy() - traj.r[i])),
                lids=[f.landmark_ids.copy() for f in mf.frames]))
            if prof is not None and fi == b - 1:
                wall_ms = 1e3 * (time.perf_counter() - t_prof)
                prof.__exit__(None, None, None)
                summary = profile_summary(prof, b - a, wall_ms)
                prof = None
    return est, fe, rows, trajectory, summary, log


def vio_result(est, rows, trajectory, traj) -> dict:
    """ATE (Umeyama-aligned, eval/ate.py) and the run's counts; the
    trajectory, landmark table and keypoint-to-landmark ids as arrays for
    the rerun comparison."""
    from okvis_tpu_torch.eval.ate import ate_rmse

    est_ts = np.asarray([int(round(t * 1e9)) for t, _, _ in trajectory], np.int64)
    est_p = np.stack([T.r.numpy() for _, _, T in trajectory])
    lm = sorted(est.landmarks.values(), key=lambda r: r.id)
    init = [r["frame"] for r in rows if r["initialized"]]
    return dict(
        ate_m=ate_rmse(est_ts, est_p, (traj.ts * 1e9).astype(np.int64), traj.r), frames_tracked=len(trajectory),
        landmarks=est.num_landmarks(), keyframes=sum(r["keyframe"] for r in rows),
        initialized_at_frame=init[0] if init else None,
        arrays=dict(
            trajectory=np.stack([np.concatenate([T.r.numpy(), T.q.numpy()]) for _, _, T in trajectory]),
            landmark_ids=np.asarray([r.id for r in lm]), landmark_slots=np.asarray([r.slot for r in lm]),
            hp_W=est.hp_W.copy(), keypoint_landmarks=np.stack([np.stack(r["lids"]) for r in rows])))


def vio_line(rows, summary, result, log, rounds_checked) -> dict:
    """The `vio` JSON line: host ms per stage (median, max) after two
    warm-up frames and outside the profiled frames, syncs a frame by
    counter, launches and busy share of the profiled frames, the Hamming
    launches a frame at the association shape, the gates' quantities."""
    timed = [r for r in rows[2:] if not r["profiled"]]
    line = dict(frames=len(rows), timed_frames=len(timed), keypoints=VIO_KEYPOINTS, dtype="float32",
                window=dict(S=9, L=512, O=2048), solver="LM + Newton-Schulz")
    for key in ("detect_ms", "add_ms", "matching_ms", "optimize_ms", "marginalize_ms", "frame_ms"):
        vals = [r[key] for r in timed]
        line[key] = dict(median=statistics.median(vals), max=max(vals))
    # each span's host ms a frame and its share of the timed frames' time
    # (the spans wait for the card before and after, so a share counts
    # the host and device time the frame spends inside the call)
    total = sum(r["frame_ms"] for r in timed)
    line["spans"] = {k: dict(median_ms=statistics.median(r["spans_ms"][k] for r in timed),
                             share=sum(r["spans_ms"][k] for r in timed) / total) for k in VIO_SPANS}
    counters = sorted({k for r in rows[2:] for k in r["syncs"]})
    line["syncs_per_frame"] = {k: sum(r["syncs"].get(k, 0) for r in rows[2:]) / len(rows[2:]) for k in counters}
    line["profile"] = summary
    assoc = [r for r in rows if r["frame"] > 0]
    line["hamming_association_per_frame"] = sum(r["hamming_association"] for r in assoc) / len(assoc)
    line["hamming_per_frame"] = sum(r["hamming"] for r in rows) / len(rows)
    line["harris_per_frame"] = sorted({r["harris"] for r in rows})
    line["association_shapes"] = sorted({tuple(s) for r in rows for s in r["association_shapes"]})
    line["recovery_rounds"] = sum(kind == "recovery" for kind, _ in log.shapes)
    line["association_rounds_sync_free"] = rounds_checked
    line["position_error_m"] = [r["position"] for r in rows]
    line["bound_keypoints"] = [r["bound"] for r in rows]
    line.update({k: v for k, v in result.items() if k != "arrays"})
    line["jax_cpu_reference"] = JAX_VIO
    return line


def check_vio() -> dict:
    """The vio phase: VIO_FRAMES rendered stereo frames through the per-frame
    loop on the card, twice (the second run with every association round
    under set_sync_debug_mode("error")); the gates of VIO_GATES; both hand
    kernels on the path; the Hamming kernel held to its plain version at
    the association shape the run gave it. Returns the Hamming kernel's
    association fields for the `kernels` line."""
    import torch

    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming import masked_distance_matrix_plain, unpack_to_pm1
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    scene = vio_scene()
    harris_suppressed_cuda.launches = 0
    hamming_matrix_cuda.launches = 0
    est, fe, rows, trajectory, summary, log = run_vio(scene, profile=True)
    launches = dict(harris_nms=harris_suppressed_cuda.launches, hamming=hamming_matrix_cuda.launches)
    result = vio_result(est, rows, trajectory, scene.traj)
    est2, _fe2, rows2, trajectory2, _s, log2 = run_vio(scene, sync_check=True)
    result2 = vio_result(est2, rows2, trajectory2, scene.traj)
    same = {k: bool(np.array_equal(result["arrays"][k], result2["arrays"][k])) for k in result["arrays"]}
    line = vio_line(rows, summary, result, log, log2.rounds)
    line["bitwise_equal_rerun"] = same
    line["launches"] = launches
    print("vio_frames", json.dumps([{k: r[k] for k in ("frame", "keypoints", "bound", "landmarks", "keyframe",
                                                       "initialized", "harris", "hamming", "hamming_association",
                                                       "position", "frame_ms")} for r in rows]))

    # the Hamming kernel at the association shape this run gave it
    args = log.assoc_args
    dk = hamming_matrix_cuda(*args)
    dp = masked_distance_matrix_plain(*args)
    torch.cuda.synchronize()
    err = int((dk - dp).abs().max())
    g, na, nb = dk.shape
    n_bytes = sum(x.numel() * x.element_size() for x in args if x is not None) + g * na * nb * 4
    bound_ms, bound_by = bound(n_bytes, *({c: n * g * na * nb for c, n in r.items()} for r in HAMMING_ROUTES))
    va, vb = (unpack_to_pm1(x.reshape(-1, 16)).reshape(g, -1, 512) for x in args[:2])
    assoc = dict(shape=[g, na, nb], ms=device_ms(lambda: hamming_matrix_cuda(*args)),
                 plain_ms=device_ms(lambda: masked_distance_matrix_plain(*args)),
                 library_ms=device_ms(lambda: torch.bmm(va, vb.transpose(1, 2))), bound_ms=bound_ms,
                 bound_by=bound_by, max_abs_err=err, launches_per_frame=line["hamming_association_per_frame"])
    line["hamming_association_kernel"] = assoc
    # host syncs of one call of each program, on the inputs of its last call
    # in the run (the 2D-2D RANSAC's SVD and eigh read LAPACK's info)
    line["syncs_per_call"] = {name: count_syncs(lambda: fn(*a, **kw)) for name, (fn, a, kw) in log.calls.items()}
    # one association round alone: its kernel time and launches, and its
    # host time with the card waited for
    fn, a, kw = log.calls["associate_multicam"]
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*a, **kw)
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    line["associate_multicam_call"] = dict(host_ms=statistics.median(host), **profile_call(lambda: fn(*a, **kw)))
    print("vio", json.dumps(line))

    gates = VIO_GATES
    ref = JAX_VIO["float32"]
    fails = []
    if result["frames_tracked"] < gates["frames_tracked"]:
        fails.append(f"{result['frames_tracked']} frames tracked")
    if not (result["ate_m"] is not None and result["ate_m"] < gates["ate_m"]
            and result["ate_m"] <= ref["ate_m"] + gates["ate_margin_m"]):
        fails.append(f"ATE {result['ate_m']}")
    if (result["landmarks"] <= gates["landmarks"]
            or abs(result["landmarks"] - ref["landmarks"]) > gates["landmarks_rel"] * ref["landmarks"]):
        fails.append(f"{result['landmarks']} landmarks")
    if result["keyframes"] != ref["keyframes"]:
        fails.append(f"{result['keyframes']} keyframes")
    if result["initialized_at_frame"] != ref["initialized_at_frame"]:
        fails.append(f"tracking initialized at frame {result['initialized_at_frame']}")
    if line["harris_per_frame"] != [1]:
        fails.append(f"Harris launches a frame {line['harris_per_frame']}")
    if min(r["hamming_association"] for r in rows if r["frame"] > 0) < 1:
        fails.append("a frame after the first made no association-shape Hamming launch")
    if line["syncs_per_call"].get("associate_multicam", 1) or line["syncs_per_call"].get("gated_match_pairs"):
        fails.append(f"the association syncs: {line['syncs_per_call']}")
    if log2.rounds < len(rows) - 1:
        fails.append(f"only {log2.rounds} association rounds ran sync-checked")
    if not all(same.values()):
        fails.append(f"the rerun differs: {same}")
    if err or not torch.equal(dk, dp):
        fails.append(f"Hamming kernel differs from its plain version at {tuple(dk.shape)}")
    if min(launches.values()) == 0:
        fails.append(f"a kernel of the path was never launched: {launches}")
    if fails:
        raise SmokeError("vio phase: " + "; ".join(fails))
    return dict(launches=launches, association=assoc, frame_ms=line["frame_ms"]["median"], arrays=result["arrays"])


# ---------------------------------------------------------------------------
# the runtime phase: the vio scene through the port's ThreadedVio
# ---------------------------------------------------------------------------


def runtime_params():
    """VioParameters built in code: the EuRoC defaults, VIO_KEYPOINTS
    keypoints a camera at threshold 40."""
    from okvis_tpu_torch.config import VioParameters

    p = VioParameters()
    p.optimization.max_num_keypoints = VIO_KEYPOINTS
    p.optimization.detection_threshold = 40.0
    return p


def runtime_checkpoint(vio, directory: str, params) -> dict:
    """save_checkpoint, then load_checkpoint into a fresh ThreadedVio of
    `params` on the same device and rig: whether each
    field of the restored window (convert.estimator_to_numpy) equals the
    saved one exactly, and where the restored marginal prior lives."""
    import torch

    from okvis_tpu_torch import convert
    from okvis_tpu_torch.pipeline import ThreadedVio

    path = f"{directory}/vio.ckpt"
    vio.save_checkpoint(path)
    fresh = ThreadedVio(params, rig=vio.rig, blocking=True, dtype=torch.float32, device=vio.device)
    try:
        fresh.load_checkpoint(path)
        a, b = convert.estimator_to_numpy(vio.estimator), convert.estimator_to_numpy(fresh.estimator)
        prior = fresh.estimator.marg_H
        return dict(same={k: same_values(a[k], b[k]) for k in a}, frames=len(a["states"]),
                    landmarks=len(a["landmarks"]), multiframes=len(fresh.estimator.multiframes),
                    prior_device=str(prior.device) if isinstance(prior, torch.Tensor) else "host")
    finally:
        fresh.shutdown()


def same_values(a, b) -> bool:
    """Exact equality of nested plain values and numpy arrays."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_values(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_values(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(a, b))
    return a == b


def run_runtime(scene, dev: str = "cuda", mode: str = "runtime", n_frames=None, profile: bool = False,
                checkpoint_dir=None, snapshot_after=None):
    """The scene's first `n_frames` frames (all by default) through the
    port's ThreadedVio in blocking mode in float32, fed as
    tests/test_vision_e2e.py feeds, with timestamps rounded to the ns
    (utils.time.ns_from_sec): the IMU up to 25 ms past a frame (each
    add_imu_measurement timed on the host: in the runtime it propagates and
    publishes the state synchronously), the images, wait_idle. `mode` is
    "runtime" (runtime_params, the EuRoC rig with overlaps, a
    propagated-state callback, a transferred-landmarks callback and a state
    CSV file), one of MODES (modes_params, modes_rig, pyramid's detection
    mask; no callbacks, no CSV) or "posegraph" (the runtime's rig and
    parameters with the pose graph on; a loop-closure callback and no
    other, no CSV; each keyframe's pose-graph feed's Hamming launches, and
    each query's best candidate and score). Per frame: the host ms from the first
    add_image to wait_idle's return, syncstats, the kernels' launches, the
    association-shape Hamming launches, and the keypoint-to-landmark ids;
    over the run, both kernels' launches by shape (kernel_shapes: `shapes`,
    and the pose-graph layer's alone, `posegraph_shapes`), the association
    batches' shapes and the last batch's arguments. With `profile`, the
    frames of RUNTIME_PROFILE_FRAMES run under torch.profiler; with
    `checkpoint_dir`, runtime_checkpoint runs after RUNTIME_CHECKPOINT_AFTER
    frames; with `snapshot_after`, the estimator's landmark ids and table
    after that many frames are kept (`snapshot`). "distributed" is the
    runtime's rig and parameters with the estimator's window sharded over
    DISTRIBUTED["runtime_shards"] shards on `dev`
    (Estimator.enable_distributed before the first frame). Returns a
    namespace of the run's records."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity

    from okvis_tpu_torch.frontend import kernels
    from okvis_tpu_torch.pipeline import ThreadedVio
    from okvis_tpu_torch.utils import syncstats
    from okvis_tpu_torch.utils.ids import IdProvider
    from okvis_tpu_torch.utils.time import ns_from_sec
    from okvis_tpu_torch.utils.timing import Timing

    rig = modes_rig(mode, dev)
    params = modes_params(mode)
    IdProvider.reset()
    Timing.reset()
    vio = ThreadedVio(params, rig=rig, blocking=True, dtype=torch.float32, device=dev)
    if mode == "distributed":
        from okvis_tpu_torch.parallel import make_mesh

        vio.estimator.enable_distributed(mesh=make_mesh(devices=[dev] * DISTRIBUTED["runtime_shards"]))
    if mode == "pyramid":
        vio.frontend.cfg.detection_masks = (modes_mask(),) * rig.num_cameras
    out = SimpleNamespace(vio=vio, rows=[], published=[], transferred=[], mfs=[], checkpoint=None, profile=None,
                          stages=None, csv_rows=None, shapes={}, assoc_shapes=set(), assoc_args=None,
                          calibration=None, posegraph_feeds=[], posegraph_shapes={}, posegraph_queries=[],
                          loop_callbacks=[], snapshot=None)
    if vio.posegraph is not None:
        vio.loop_closure_callback = out.loop_callbacks.append
        feed, query = vio._feed_posegraph, vio.posegraph.db.query

        def recorded_query(*args, **kw):
            res = query(*args, **kw)
            out.posegraph_queries.append(res[:2])
            return res

        vio.posegraph.db.query = recorded_query

        def counted_feed(*args):
            h0 = kernel_counts()["hamming"]
            with kernel_shapes(out.posegraph_shapes):
                feed(*args)
            out.posegraph_feeds.append(kernel_counts()["hamming"] - h0)

        vio._feed_posegraph = counted_feed
    callbacks = mode == "runtime"
    if callbacks:
        vio.propagated_state_callback = lambda t, T, sb: out.published.append((t, T.r.numpy().copy()))
        vio.transferred_landmarks_callback = lambda t, lms: out.transferred.append((t, sorted(lms)))
    assoc = vio.frontend.data_association_and_initialization

    def record(est, T_WS, mf, sb_prop=None):
        out.mfs.append(mf)
        return assoc(est, T_WS, mf, sb_prop=sb_prop)

    vio.frontend.data_association_and_initialization = record
    shapes = []
    orig_mdm = kernels.masked_distance_matrix

    def mdm(*args):
        res = orig_mdm(*args)
        shapes.append(res.dim() == 3)  # the association round's (P·C, K, K) batch
        if res.dim() == 3:
            out.assoc_args = args
            out.assoc_shapes.add(tuple(res.shape))
        return res

    kernels.masked_distance_matrix = mdm
    traj = scene.traj
    # the runtime's clock: seconds rounded to the nearest ns (the IMU
    # samples are multiples of 5 ms), the clock vio_imu_slice gives the vio
    # phase, so both card paths see the same numbers
    ts_ns = [int(ns_from_sec(t)) for t in traj.ts]
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    a, b = RUNTIME_PROFILE_FRAMES
    imu_i, prof, n_opt = 0, None, 0
    frames = list(zip(scene.times, scene.images))[:n_frames]
    tmp = tempfile.TemporaryDirectory()
    csv = f"{tmp.name}/state.csv"
    recorder = contextlib.ExitStack()
    try:
        recorder.enter_context(kernel_shapes(out.shapes))
        if callbacks:
            vio.set_state_csv_file(csv)
        for fi, (t, images) in enumerate(frames):
            if profile and fi == a:
                sync()
                prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
                t_prof = time.perf_counter()
            syncstats.reset()
            n_shapes, counts0 = len(shapes), kernel_counts()
            t_ns = int(ns_from_sec(t))
            imu_ms = []
            while imu_i < len(ts_ns) and ts_ns[imu_i] <= t_ns + 25_000_000:
                t0 = time.perf_counter()
                vio.add_imu_measurement(ts_ns[imu_i], traj.gyro[imu_i], traj.acc[imu_i])
                imu_ms.append(1e3 * (time.perf_counter() - t0))
                imu_i += 1
            t0 = time.perf_counter()
            for c, image in enumerate(images):
                vio.add_image(t_ns, c, image)
            vio.wait_idle(timeout=120)
            frame_ms = 1e3 * (time.perf_counter() - t0)
            state = vio.trajectory[-1] if vio.trajectory and vio.trajectory[-1].timestamp_ns == t_ns else None
            i = int(round(t * 200))
            out.rows.append(dict(
                frame=fi, frame_ms=frame_ms, imu_ms=imu_ms, syncs=syncstats.snapshot(), profiled=prof is not None, tracked=state is not None,
                keyframe=bool(state is not None and state.is_keyframe), initialized=vio.frontend.is_initialized,
                harris=kernel_counts()["harris_nms"] - counts0["harris_nms"],
                hamming=kernel_counts()["hamming"] - counts0["hamming"],
                hamming_association=sum(shapes[n_shapes:]), landmarks=vio.estimator.num_landmarks(),
                position=None if state is None else float(np.linalg.norm(state.T_WS.r.numpy() - traj.r[i])),
                lids=[f.landmark_ids.copy() for f in out.mfs[-1].frames] if state is not None else None))
            if fi == 1:  # two warm-up frames: the Timing table and latencies from here on
                Timing.reset()
                n_opt = len(vio.opt_latencies)
            if fi + 1 == snapshot_after:
                out.snapshot = (sorted(vio.estimator.landmarks), np.array(vio.estimator.hp_W, copy=True))
            if checkpoint_dir is not None and fi + 1 == RUNTIME_CHECKPOINT_AFTER:
                out.checkpoint = runtime_checkpoint(vio, checkpoint_dir, params)
            if prof is not None and fi == b - 1:
                wall_ms = 1e3 * (time.perf_counter() - t_prof)
                prof.__exit__(None, None, None)
                out.profile = profile_summary(prof, b - a, wall_ms)
                prof = None
        out.stages = {name: dict(count=acc.count, mean_ms=1e3 * acc.mean, min_ms=1e3 * acc.min, max_ms=1e3 * acc.max)
                      for name, acc in Timing._timers.items() if name in RUNTIME_STAGES}
        out.opt_latencies_ms = [1e3 * x for x in vio.opt_latencies[n_opt:]]
        if mode == "per_state":
            est = vio.estimator
            true_r1 = modes_rig("runtime", "cpu").T_SC.r[1].numpy()
            out.calibration = dict(
                before=float(np.linalg.norm(MODES_OFFSET)),
                after=float(np.linalg.norm(est.r_SC_t[est._last_state().slot, 1] - true_r1)),
                dense_dim=est.cfg.dense_dim)
    finally:
        recorder.close()
        kernels.masked_distance_matrix = orig_mdm
        try:
            vio.shutdown()
        finally:
            if callbacks:
                with open(csv) as f:
                    out.csv_rows = len(f.read().splitlines()) - 1
            tmp.cleanup()
    out.frames_fed, out.frames_processed = len(frames), vio._frames_processed
    return out


def runtime_result(out, traj) -> dict:
    """The runtime's ATE and counts, as vio_result gives the vio loop's, with
    the arrays of the rerun comparison."""
    from okvis_tpu_torch.eval.ate import ate_rmse

    states = out.vio.trajectory
    est = out.vio.estimator
    lm = sorted(est.landmarks.values(), key=lambda r: r.id)
    init = [r["frame"] for r in out.rows if r["initialized"]]
    return dict(
        ate_m=ate_rmse(np.asarray([s.timestamp_ns for s in states], np.int64),
                       np.stack([s.T_WS.r.numpy() for s in states]), (traj.ts * 1e9).astype(np.int64), traj.r),
        frames_tracked=len(states), landmarks=est.num_landmarks(), keyframes=sum(s.is_keyframe for s in states),
        initialized_at_frame=init[0] if init else None,
        arrays=dict(
            trajectory=np.stack([np.concatenate([s.T_WS.r.numpy(), s.T_WS.q.numpy()]) for s in states]),
            landmark_ids=np.asarray([r.id for r in lm]), landmark_slots=np.asarray([r.slot for r in lm]),
            hp_W=est.hp_W.copy(),
            keypoint_landmarks=np.stack([np.stack(r["lids"]) for r in out.rows if r["lids"] is not None])))


def check_runtime(vio: dict, dev: str = "cuda") -> dict:
    """The runtime phase: the vio scene through the port's ThreadedVio on
    the card, twice (the first run profiled over RUNTIME_PROFILE_FRAMES and
    checkpointed after RUNTIME_CHECKPOINT_AFTER frames, the second timed);
    the gates of RUNTIME_GATES; both hand kernels on the path. `vio` is
    check_vio's result: its median frame ms and arrays, which the `runtime`
    line compares with. Prints the `runtime_frames` and `runtime` lines;
    returns the first run's kernel launches for the `kernels` line."""
    import tempfile

    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    scene = vio_scene()
    harris_suppressed_cuda.launches = 0
    hamming_matrix_cuda.launches = 0
    with tempfile.TemporaryDirectory() as ckpt:
        run1 = run_runtime(scene, dev, profile=dev == "cuda", checkpoint_dir=ckpt)
    launches = dict(harris_nms=harris_suppressed_cuda.launches, hamming=hamming_matrix_cuda.launches)
    result = runtime_result(run1, scene.traj)
    run2 = run_runtime(scene, dev)
    result2 = runtime_result(run2, scene.traj)
    same = {k: bool(np.array_equal(result["arrays"][k], result2["arrays"][k])) for k in result["arrays"]}
    print("runtime_frames", json.dumps([{k: r[k] for k in ("frame", "tracked", "keyframe", "initialized", "landmarks",
                                                           "harris", "hamming", "hamming_association", "position",
                                                           "frame_ms", "profiled")} for r in run1.rows]))

    # time statistics from the second run (no profiler) after two warm-up
    # frames; the busy share and launches from the first run's profiled frames
    timed = run2.rows[2:]
    frame_ms = [r["frame_ms"] for r in timed]
    first_state = run1.vio.trajectory[0].timestamp_ns
    publish_ms = [ms for r in timed for ms in r["imu_ms"]]
    counters = sorted({k for r in timed for k in r["syncs"]})
    published = run1.published
    # the last 60 samples, as tests/test_pipeline.py:226 takes them
    pub_err = [float(np.linalg.norm(p - scene.traj.r[int(round(t / 1e9 * 200))])) for t, p in published[-60:]]
    line = dict(
        frames=len(run1.rows), timed_frames=len(timed), keypoints=VIO_KEYPOINTS, dtype="float32",
        window=dict(S=9, L=512, O=2048), solver="LM + Newton-Schulz", mode="blocking",
        stages=run2.stages, frame_ms=dict(median=statistics.median(frame_ms), max=max(frame_ms)),
        opt_latencies_ms=dict(p50=float(np.percentile(run2.opt_latencies_ms, 50)),
                              p99=float(np.percentile(run2.opt_latencies_ms, 99))),
        publish_ms_per_imu_sample=dict(median=statistics.median(publish_ms), mean=statistics.fmean(publish_ms),
                                       samples=len(publish_ms)),
        syncs_per_frame={k: sum(r["syncs"].get(k, 0) for r in timed) / len(timed) for k in counters},
        frame_ms_over_vio_phase=statistics.median(frame_ms) - vio["frame_ms"], vio_phase_frame_ms=vio["frame_ms"],
        # the same frames and clock as the vio phase: the same bits expected
        equal_to_vio_phase={k: bool(np.array_equal(v, vio["arrays"][k])) for k, v in result["arrays"].items()},
        profile=run1.profile, launches=launches,
        harris_per_frame=sorted({r["harris"] for r in run1.rows}),
        hamming_association_per_frame=sum(r["hamming_association"] for r in run1.rows[1:]) / (len(run1.rows) - 1),
        propagated=dict(count=len(published), first_ns=published[0][0] if published else None,
                        first_state_ns=first_state,
                        last60_median_position_error_m=statistics.median(pub_err) if pub_err else None),
        transferred_landmarks=sum(len(ids) for _, ids in run1.transferred),
        state_csv_rows=run1.csv_rows, frames_fed=run1.frames_fed, frames_processed=run1.frames_processed,
        checkpoint=run1.checkpoint, bitwise_equal_rerun=same, position_error_m=[r["position"] for r in run1.rows],
        jax_cpu_reference=JAX_RUNTIME)
    line.update({k: v for k, v in result.items() if k != "arrays"})
    print("runtime", json.dumps(line))

    gates, ref = RUNTIME_GATES, JAX_RUNTIME["float32"]
    fails = []
    for run in (run1, run2):
        if run.frames_processed != run.frames_fed:
            fails.append(f"{run.frames_processed} of {run.frames_fed} frames processed")
    if result["frames_tracked"] < gates["frames_tracked"]:
        fails.append(f"{result['frames_tracked']} frames tracked")
    if not (result["ate_m"] is not None and result["ate_m"] < gates["ate_m"]
            and result["ate_m"] <= ref["ate_m"] + gates["ate_margin_m"]):
        fails.append(f"ATE {result['ate_m']}")
    if abs(result["landmarks"] - ref["landmarks"]) > gates["landmarks_rel"] * ref["landmarks"]:
        fails.append(f"{result['landmarks']} landmarks")
    if result["keyframes"] != ref["keyframes"]:
        fails.append(f"{result['keyframes']} keyframes")
    if result["initialized_at_frame"] != ref["initialized_at_frame"]:
        fails.append(f"tracking initialized at frame {result['initialized_at_frame']}")
    if line["harris_per_frame"] != [1]:
        fails.append(f"Harris launches a frame {line['harris_per_frame']}")
    if min(r["hamming_association"] for r in run1.rows[1:]) < 1:
        fails.append("a frame after the first made no association-shape Hamming launch")
    prop = line["propagated"]
    if not (published and prop["first_ns"] > prop["first_state_ns"]
            and prop["last60_median_position_error_m"] < gates["propagated_error_m"]):
        fails.append(f"propagated states {prop}")
    if run1.csv_rows != result["frames_tracked"]:
        fails.append(f"{run1.csv_rows} state CSV rows for {result['frames_tracked']} states")
    if not all(same.values()):
        fails.append(f"the rerun differs: {same}")
    ck = run1.checkpoint
    if ck is None or not all(ck["same"].values()) or ck["prior_device"] == "host":
        fails.append(f"checkpoint round trip: {ck}")
    if min(launches.values()) == 0:
        fails.append(f"a kernel of the path was never launched: {launches}")
    if fails:
        raise SmokeError("runtime phase: " + "; ".join(fails))
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# the modes phase: scale-space + masked detection, per-state extrinsics and
# the monocular rig, each through the port's ThreadedVio
# ---------------------------------------------------------------------------

# pyramid: the runtime phase's frames with detection_octaves = 2 and a
# detection mask a camera that blanks the left 64 columns and the bottom 48
# rows (a vehicle body in view); per_state: the same frames, both relative
# extrinsics sigmas nonzero (tests/test_pipeline.py:455's values), the
# estimator's camera-1 translation MODES_OFFSET off the truth that rendered
# the frames (tests/test_estimator.py:204); mono: camera 0 alone on
# tests/test_vision_e2e.py:158's gentle-motion world (trajectory seed 41,
# 300 landmarks at 4-9 m), rendered for MODES_MONO_FRAMES frames, of which
# the first MODES_MONO_FED are fed (the world and its first frames stay
# those of the 60-frame run; the script's time limit cut the rest).
# VioParameters as
# runtime_params (EuRoC defaults, 400 keypoints, threshold 40, the default
# window), blocking mode, float32 on the card. Each mode runs again over its
# first MODES_RERUN_FRAMES frames for the bitwise comparison: 12 for the
# stereo modes (past the first marginalization of landmarks, at frame 10 in
# both), 20 for mono (it initializes at frame 16); the per_state run is
# checkpointed after RUNTIME_CHECKPOINT_AFTER frames.
MODES = ("pyramid", "per_state", "mono")
MODES_MONO_FRAMES = 60
MODES_MONO_FED = 40
MODES_RERUN_FRAMES = dict(pyramid=12, per_state=12, mono=20)
MODES_MASK = dict(left=64, bottom=48)
MODES_OFFSET = (0.004, -0.003, 0.002)
MODES_PER_STATE_SIGMAS = dict(sigma_c_relative_translation=1e-4, sigma_c_relative_orientation=1e-5,
                              sigma_absolute_translation=0.05, sigma_absolute_orientation=0.02)
# The JAX package's ThreadedVio on the same frames on the CPU
# (scripts/jax_modes.py; a CPU run, not a device metric). Its mono reading
# is of the 40 frames the phase feeds of the 60-frame world
# (scripts/jax_modes.py float32 mono 60:40; of all 60: ATE 0.2960 m, 82
# landmarks, 10 keyframes, initialized at frame 16); mono is held to bounds
# only
JAX_MODES = dict(float32=dict(
    pyramid=dict(ate_m=0.022639131980574545, frames_tracked=20, landmarks=127, keyframes=7, initialized_at_frame=2),
    per_state=dict(ate_m=0.022438408627563387, frames_tracked=20, landmarks=178, keyframes=1, initialized_at_frame=None,
                   calibration_error_m=dict(before=0.005385164807134504, after=0.0038642948493361473)),
    mono=dict(frames=60, frames_fed=40, ate_m=0.3082743513537993, frames_tracked=40, landmarks=133, keyframes=5,
              initialized_at_frame=16),
))
# Gates: frames tracked (n - 3, the JAX end-to-end tests' floor), the JAX
# tests' ATE bounds (tests/test_vision_e2e.py:71 for stereo, :201 for the
# gentle mono) and the JAX float32 CPU run's ATE plus a margin, landmarks
# within landmarks_rel of its count, for the stereo modes its first tracked
# frame and its keyframes within keyframes_margin; per_state: the camera-1
# calibration error falls. The margins were set, as the vio phase's, from
# three readings of each mode: the JAX float32 CPU run (JAX_MODES), the
# port's float32 CPU run (check_modes(dev="cpu")) and the card's. pyramid:
# ATE 0.0226, 0.0210, 0.0145 m; 127, 124, 116 landmarks; 7, 6, 6 keyframes
# (one keyframe decision goes the other way in float32 in the port, on
# either device; in float64 the two packages agree, tests/test_torch_mono.py
# :test_full_vision_multi_octave_detection). per_state: 0.0224, 0.0234,
# 0.0239 m; 178, 188, 180 landmarks; 1 keyframe and no 2D-2D initialization
# in all three (the gate inflation of online calibration). The mono run is
# a lottery of discrete decisions (tests/test_vision_e2e.py:194) and is held
# to bounds only.
MODES_GATES = dict(
    pyramid=dict(ate_m=0.15, ate_margin_m=0.003, landmarks_rel=0.1, keyframes_margin=1, same_decisions=True),
    per_state=dict(ate_m=0.15, ate_margin_m=0.003, landmarks_rel=0.1, keyframes_margin=0, same_decisions=True),
    mono=dict(ate_m=0.6, ate_margin_m=None, landmarks_rel=None, keyframes_margin=None, same_decisions=False),
)


def modes_mask():
    """The pyramid mode's (480, 752) detection mask: True where detection
    may fire."""
    mask = np.ones((480, 752), bool)
    mask[:, : MODES_MASK["left"]] = False
    mask[-MODES_MASK["bottom"]:] = False
    return mask


def modes_rig(mode: str, dev: str):
    """The rig a run_runtime mode's ThreadedVio gets: the EuRoC stereo rig
    with overlaps (runtime, pyramid), camera 1's translation MODES_OFFSET
    off in per_state, camera 0 alone in mono."""
    import torch

    from okvis_tpu_torch import kinematics as kin
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig

    specs, T_SC, intr = euroc_stereo_rig(device=dev)
    r = T_SC.r.clone()
    if mode == "per_state":
        r[1] += torch.tensor(MODES_OFFSET, dtype=r.dtype, device=r.device)
    n = 1 if mode == "mono" else 2
    rig = NCameraSystem(specs=specs[:n], T_SC=kin.SE3(r=r[:n], q=T_SC.q[:n]), intrinsics=intr[:n])
    rig.compute_overlaps()
    return rig


def modes_params(mode: str):
    """The VioParameters of a run_runtime mode: runtime_params, with two
    octaves in pyramid, MODES_PER_STATE_SIGMAS in per_state and the pose
    graph on (min_gap POSEGRAPH_RUNTIME["min_gap"]) in posegraph."""
    p = runtime_params()
    if mode == "posegraph":
        p.posegraph.enabled = True
        p.posegraph.min_gap = POSEGRAPH_RUNTIME["min_gap"]
    if mode == "pyramid":
        p.optimization.detection_octaves = 2
    if mode == "per_state":
        for k, v in MODES_PER_STATE_SIGMAS.items():
            setattr(p.camera_params, k, v)
    return p


def modes_scenes() -> dict:
    """The frames of each mode, rendered on the CPU: the vio scene (stereo)
    and the gentle-motion mono scene."""
    from okvis_tpu_torch import kinematics as kin
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.synthetic import (
        euroc_stereo_rig, gentle_mono_trajectory, make_landmarks, render_scenario)

    stereo = vio_scene()
    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    mono_rig = NCameraSystem(specs=specs[:1], T_SC=kin.SE3(r=T_SC.r[:1], q=T_SC.q[:1]), intrinsics=intr[:1])
    traj = gentle_mono_trajectory(MODES_MONO_FRAMES)
    mono = render_scenario(mono_rig, traj, make_landmarks(traj, 300, seed=42, radius=(4.0, 9.0)), MODES_MONO_FRAMES)
    return dict(pyramid=stereo, per_state=stereo, mono=mono)


def check_modes(dev: str = "cuda") -> dict:
    """The modes phase: each of MODES through the port's ThreadedVio on the
    card with its launch counters zeroed before and read after, then its
    first MODES_RERUN_FRAMES frames again for bitwise equality; the gates of
    MODES_GATES; both hand kernels on each mode's path; the Harris kernel
    held to its plain version at every pyramid level's shape with the mask
    over the whole image, and the Hamming kernel at the mono association
    shape. Prints a `modes_frames` and a `modes` line a mode and a
    `modes_kernels` line; returns the launches and kernel entries for the
    `kernels` line."""
    import tempfile

    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    t0 = time.perf_counter()
    scenes = modes_scenes()
    print(f"modes_scene_seconds {time.perf_counter() - t0:.2f}")
    results, runs, fails = {}, {}, []
    for mode in MODES:
        scene = scenes[mode]
        t0 = time.perf_counter()
        harris_suppressed_cuda.launches = 0
        hamming_matrix_cuda.launches = 0
        with tempfile.TemporaryDirectory() as ckpt:
            run1 = run_runtime(scene, dev, mode, n_frames=MODES_MONO_FED if mode == "mono" else None,
                               profile=dev == "cuda", checkpoint_dir=ckpt if mode == "per_state" else None,
                               snapshot_after=MODES_RERUN_FRAMES[mode])
        launches = dict(harris_nms=harris_suppressed_cuda.launches, hamming=hamming_matrix_cuda.launches)
        run2 = run_runtime(scene, dev, mode, n_frames=MODES_RERUN_FRAMES[mode],
                           snapshot_after=MODES_RERUN_FRAMES[mode])
        result = runtime_result(run1, scene.traj)
        same = mode_rerun_equal(run1, run2)
        runs[mode] = run1
        timed = [r for r in run1.rows[2:] if not r["profiled"]]
        frame_ms = [r["frame_ms"] for r in timed]
        counters = sorted({k for r in timed for k in r["syncs"]})
        line = dict(
            mode=mode, frames=len(run1.rows), cameras=run1.vio.rig.num_cameras, keypoints=VIO_KEYPOINTS,
            dtype="float32", dense_dim=run1.vio.estimator.cfg.dense_dim, mode_settings=mode_settings(mode),
            frame_ms=dict(median=statistics.median(frame_ms), max=max(frame_ms), timed_frames=len(frame_ms)),
            syncs_per_frame={k: sum(r["syncs"].get(k, 0) for r in timed) / len(timed) for k in counters},
            profile=run1.profile, launches=launches,
            launches_per_frame={k: v / len(run1.rows) for k, v in launches.items()},
            harris_per_frame=sorted({r["harris"] for r in run1.rows}),
            harris_per_frame_by_shape=shapes_of(run1.shapes, len(run1.rows)).get("harris_nms", {}),
            hamming_association_per_frame=sum(r["hamming_association"] for r in run1.rows[1:]) / (len(run1.rows) - 1),
            association_shapes=sorted(run1.assoc_shapes), calibration_error_m=run1.calibration,
            checkpoint=run1.checkpoint, frames_fed=run1.frames_fed, frames_processed=run1.frames_processed,
            bitwise_equal_rerun=same, position_error_m=[r["position"] for r in run1.rows],
            jax_cpu_reference=JAX_MODES["float32"][mode], gates=MODES_GATES[mode],
            seconds=time.perf_counter() - t0)
        line.update({k: v for k, v in result.items() if k != "arrays"})
        print("modes_frames", json.dumps(dict(mode=mode, frames=[
            {k: r[k] for k in ("frame", "tracked", "keyframe", "initialized", "landmarks", "harris", "hamming",
                               "hamming_association", "position", "frame_ms", "profiled")} for r in run1.rows])))
        print("modes", json.dumps(line))
        results[mode] = line
        fails += [f"{mode}: {f}" for f in mode_fails(mode, line, run1)]
    kern = check_mode_kernels(runs)
    if kern.pop("fails"):
        fails.append(f"kernels against their plain versions: {kern}")
    print("modes_kernels", json.dumps(kern))
    if fails:
        raise SmokeError("modes phase: " + "; ".join(fails))
    return dict(launches={m: r["launches"] for m, r in results.items()}, kernels=kern)


def mode_settings(mode: str) -> dict:
    if mode == "pyramid":
        return dict(detection_octaves=2, mask=MODES_MASK)
    if mode == "per_state":
        return dict(MODES_PER_STATE_SIGMAS, camera1_offset_m=MODES_OFFSET)
    return dict(cameras=1, scene="tests/test_vision_e2e.py:158 (seed 41, 300 landmarks at 4-9 m)")


def mode_rerun_equal(run1, run2) -> dict:
    """The rerun of the first MODES_RERUN_FRAMES frames against the first
    run: every frame's keypoint-to-landmark ids, the trajectory, and the
    landmark ids and table after the rerun's last frame."""
    n = len(run2.rows)
    lids = [(a["lids"], b["lids"]) for a, b in zip(run1.rows[:n], run2.rows)]
    pose = lambda states: np.stack([np.concatenate([s.T_WS.r.numpy(), s.T_WS.q.numpy()]) for s in states])  # noqa: E731
    t2 = pose(run2.vio.trajectory)
    same = dict(
        keypoint_landmarks=all((a is None) == (b is None) and (a is None or all(map(np.array_equal, a, b)))
                               for a, b in lids),
        trajectory=bool(np.array_equal(pose(run1.vio.trajectory[: len(t2)]), t2)))
    (ids1, hp1), (ids2, hp2) = run1.snapshot, run2.snapshot
    same["landmarks"] = ids1 == ids2 and bool(np.array_equal(hp1, hp2))
    return same


def mode_fails(mode: str, line: dict, run) -> list:
    gates, ref = MODES_GATES[mode], JAX_MODES["float32"][mode]
    fails = []
    n = line["frames"]
    if run.frames_processed != run.frames_fed:
        fails.append(f"{run.frames_processed} of {run.frames_fed} frames processed")
    if line["frames_tracked"] < n - 3:
        fails.append(f"{line['frames_tracked']} of {n} frames tracked")
    ate = line["ate_m"]
    if ate is None or ate >= gates["ate_m"]:
        fails.append(f"ATE {ate} (bound {gates['ate_m']})")
    if gates["ate_margin_m"] is not None and ate is not None and ate > ref["ate_m"] + gates["ate_margin_m"]:
        fails.append(f"ATE {ate} against the JAX float32 CPU run's {ref['ate_m']}")
    if gates["landmarks_rel"] is not None and \
            abs(line["landmarks"] - ref["landmarks"]) > gates["landmarks_rel"] * ref["landmarks"]:
        fails.append(f"{line['landmarks']} landmarks (JAX float32 CPU run: {ref['landmarks']})")
    if gates["same_decisions"]:
        if abs(line["keyframes"] - ref["keyframes"]) > gates["keyframes_margin"]:
            fails.append(f"{line['keyframes']} keyframes (JAX float32 CPU run: {ref['keyframes']})")
        if line["initialized_at_frame"] != ref["initialized_at_frame"]:
            fails.append(f"initialized at frame {line['initialized_at_frame']} "
                         f"(JAX float32 CPU run: {ref['initialized_at_frame']})")
    if not all(line["bitwise_equal_rerun"].values()):
        fails.append(f"the rerun differs: {line['bitwise_equal_rerun']}")
    if min(line["launches"].values()) == 0:
        fails.append(f"a kernel of the path was never launched: {line['launches']}")
    octaves = 3 if mode == "pyramid" else 1
    if line["harris_per_frame"] != [octaves]:
        fails.append(f"Harris launches a frame {line['harris_per_frame']} (want {octaves})")
    cams = line["cameras"]
    want = {f"{cams}x{480 >> o}x{752 >> o}": 1.0 for o in range(octaves)}
    if line["harris_per_frame_by_shape"] != want:
        fails.append(f"Harris launches a frame by shape {line['harris_per_frame_by_shape']} (want {want})")
    if min(r["hamming_association"] for r in run.rows[1:]) < 1 and mode != "mono":
        fails.append("a frame after the first made no association-shape Hamming launch")
    if mode == "mono" and not any(s[0] >= 1 for s in line["association_shapes"]):
        fails.append(f"no association batch: {line['association_shapes']}")
    if mode == "per_state":
        cal = line["calibration_error_m"]
        if not cal["after"] < cal["before"] or cal["dense_dim"] != 255:
            fails.append(f"calibration {cal}")
        ck = line["checkpoint"]
        if ck is None or not all(ck["same"].values()) or ck["prior_device"] == "host":
            fails.append(f"checkpoint round trip: {ck}")
    return fails


def check_mode_kernels(runs) -> dict:
    """The Harris kernel against its plain version at every pyramid level of
    the pyramid run's last frame, with the mode's mask subsampled and the
    level's border, over the whole image (raw bit for bit, the same
    suppressed values), timed with its plain version and bound, beside the
    pyramid run's launches a frame at the level's shape; the Hamming
    kernel against its plain version at the mono run's last association
    batch, timed beside torch.bmm of the ±1 form. These launches come after
    the modes' counts were read."""
    import torch

    from okvis_tpu_torch.frontend import detection
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming import masked_distance_matrix_plain, unpack_to_pm1
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    images = torch.stack([torch.as_tensor(im) for im in vio_scene().images[-1]]).to("cuda", torch.float32)
    mask = torch.from_numpy(modes_mask()).to("cuda").expand(images.shape[0], 480, 752)
    pyramid_launches = shapes_of(runs["pyramid"].shapes, len(runs["pyramid"].rows)).get("harris_nms", {})
    octaves, fails = [], False
    level = images.contiguous()
    for o in range(3):
        if o:
            level = detection._downsample2(level).contiguous()
            mask = mask[:, ::2, ::2]
        C, H, W = level.shape
        inb = (detection.border_mask(H, W, max(4, 20 >> o), level.device) & mask).to(torch.float32).contiguous()
        raw_k, sup_k = harris_suppressed_cuda(level, inb)
        raw_p, sup_p = detection.harris_suppressed_plain(level, inb)
        torch.cuda.synchronize()
        fin = torch.isfinite(sup_p)
        equal = (torch.equal(raw_k, raw_p) and torch.equal(torch.isfinite(sup_k), fin)
                 and torch.equal(sup_k[fin], sup_p[fin]))
        fails |= not equal
        px = C * H * W
        bound_ms, bound_by = bound(16 * px, {c: n * px for c, n in HARRIS_OPS_PER_PIXEL.items()})
        octaves.append(dict(
            shape=[C, H, W], border=max(4, 20 >> o), equal_whole_image=equal,
            max_abs_err=float((raw_k - raw_p).abs().max()), selected=int(fin.sum()),
            ms=device_ms(lambda: harris_suppressed_cuda(level, inb)),
            plain_ms=device_ms(lambda: detection.harris_suppressed_plain(level, inb)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            launches_per_frame_pyramid=pyramid_launches.get(f"{C}x{H}x{W}", 0.0)))
    args = runs["mono"].assoc_args
    dk = hamming_matrix_cuda(*args)
    dp = masked_distance_matrix_plain(*args)
    torch.cuda.synchronize()
    err = int((dk - dp).abs().max())
    fails |= bool(err) or not torch.equal(dk, dp)
    g, na, nb = dk.shape
    n_bytes = sum(x.numel() * x.element_size() for x in args if x is not None) + g * na * nb * 4
    bound_ms, bound_by = bound(n_bytes, *({c: n * g * na * nb for c, n in r.items()} for r in HAMMING_ROUTES))
    va, vb = (unpack_to_pm1(x.reshape(-1, 16)).reshape(x.shape[0], -1, 512) for x in args[:2])
    mono = dict(shape=[g, na, nb], max_abs_err=err, ms=device_ms(lambda: hamming_matrix_cuda(*args)),
                plain_ms=device_ms(lambda: masked_distance_matrix_plain(*args)),
                library_ms=device_ms(lambda: torch.bmm(va, vb.expand(g, -1, -1).transpose(1, 2))),
                bound_ms=bound_ms, bound_by=bound_by,
                launches_per_frame=sum(r["hamming"] for r in runs["mono"].rows) / len(runs["mono"].rows))
    return dict(harris_octaves=octaves, hamming_mono_association=mono, fails=fails)


# ---------------------------------------------------------------------------
# the posegraph phase: the pose-graph layer on the card, in three parts
# ---------------------------------------------------------------------------

# pgo: scripts/bench_posegraph.py's drifting circle with its loop edge
# (datasets.synthetic.circle_pose_graph) at each size of `nodes`, solved in
# float64 under solver "auto" (256 nodes: 1,536 unknowns, the dense
# Cholesky; 1,024: PCG) with the bench's 8 LM iterations of 60 PCG rounds;
# at `compare_nodes` also "dense" against "pcg" with tests/test_posegraph.py
# :69-86's 12 iterations and 300 PCG rounds. loop: tests/test_posegraph.py::
# TestManagerEndToEnd's square (21 keyframes, the revisit re-observes
# keyframe 0; datasets.synthetic.square_loop_keyframes) at the runtime's
# capacities, with 400 landmarks and 16-word descriptors a keyframe, so a
# query is one Hamming launch at (400, 256·400). runtime: a world the rig
# revisits (datasets.synthetic.revisit_scenario: one turn about the
# sensor's x axis in `period` s, so from frame 20 on the frames repeat frame
# 0 on), POSEGRAPH_RUNTIME["frames"] frames through ThreadedVio with the
# runtime phase's parameters, once with posegraph.enabled and min_gap
# POSEGRAPH_RUNTIME["min_gap"] and once without the pose graph (at the
# default min_gap 10 the revisit's candidates would still be excluded).
POSEGRAPH_PGO = dict(nodes=(256, 1024), max_iterations=8, pcg_iters=60, compare_nodes=256, compare_iterations=12,
                     compare_pcg_iters=300, reps=5)
POSEGRAPH_LOOP = dict(seed=11, landmarks=400, min_gap=8, score_threshold=0.2, min_inliers=15, node_capacity=256,
                      edge_capacity=512, db_kp_capacity=400, query_reps=10)
POSEGRAPH_RUNTIME = dict(frames=27, period=2.0, min_gap=2)
POSEGRAPH_SAMPLES = 8  # the pgo readings keep the poses of every (n/8)-th node and the last
# The JAX package on the CPU (scripts/jax_posegraph.py; a CPU run, not a
# device metric): pgo and loop in float64, runtime in float32. In the
# runtime run the first turn's queries score 0 (no descriptor of a keyframe
# min_gap or more back lies within 60 bits); from frame 20 on the revisit
# scores 0.30 and 1.0, and two of three verifications are accepted.
JAX_POSEGRAPH = dict(
    pgo={
        "256": dict(initial_cost=25668.25144509, final_cost=8.74259209728, iterations=8,
                    nodes=[0, 32, 64, 96, 128, 160, 192, 224, 255], poses=[
                    [40.74366543153, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
                    [21.71956912218, 22.68084219905, 0.06323898771063, 0.0006033798517222, -9.913421322457e-05,
                     0.2817009296365, 0.9595020647956],
                    [-5.432593432127, 10.2325019535, 0.02851702581681, 0.001419774821173, 0.0003921728395218,
                     0.5365519936155, 0.8438659778585],
                    [4.932669790592, -16.47915761696, 0.0086708184391, 0.001778591877887, 0.0007583307525369,
                     0.8589683486823, 0.5120250360161],
                    [27.30326212432, -0.3588774829186, -0.04263782559014, 0.001917070340042, 0.001043238087895,
                     0.9999976114178, -0.0001168511855036],
                    [5.575469986622, 16.62464580613, -0.02729707333137, 0.001710002727401, 0.00104821330648,
                     0.8604047677051, -0.5096073123983],
                    [-5.661032374535, -9.37950958095, 0.04956678754397, 0.00110991131881, 0.0009089487229517,
                     0.5409704009447, -0.8410404075969],
                    [21.2035221631, -22.42238673319, 0.06485305426487, 0.0004286470974424, 0.0007066233317293,
                     0.2845625243427, -0.9586571267585],
                    [40.69202996567, -0.9986487184646, -0.009822916245387, 2.975519110789e-06, 3.188401972361e-05,
                     0.01185229313923, -0.999929758594],
                    ]),
        "1024": dict(initial_cost=102679.2689917, final_cost=9923.324999006, iterations=8,
                    nodes=[0, 128, 256, 384, 512, 640, 768, 896, 1023], poses=[
                    [162.9746617261, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
                    [98.9362595683, 120.8204118456, -0.007631442298696, -0.0005936199293668, -0.0001377237213281,
                     0.08946916807436, 0.9959894058732],
                    [-23.069674068, 139.5115405942, 0.323865886004, -0.007271481828641, -0.005882753794709,
                     0.1663043092231, 0.9860301189587],
                    [-97.69105490742, 71.3792787524, 0.3589069997158, -0.2842577524732, 0.2743115999798,
                     0.297877611684, 0.8690337189849],
                    [-113.8564989485, -0.525199787469, 0.792759598222, 0.5839926807351, 0.4585844806409,
                     0.2601939842239, -0.6172130211984],
                    [-97.82711252142, -74.33913934786, 3.466241729242, -0.58137706931, 0.1931645782715,
                     -0.04037212554383, -0.7893403831433],
                    [-23.59561809407, -139.7701633742, 0.09211111935481, -0.009751106781713, -0.007915894014922,
                     0.1502356148335, -0.9885704398646],
                    [98.64983495522, -121.0050506799, 0.1741054693941, 0.005361955047303, -0.00536819299143,
                     0.09251941386425, -0.9956819723186],
                    [162.9092297114, -1.147463113862, 0.02903685426305, 0.0008319785323204, -0.0001880947728407,
                     0.01851706139259, -0.9998281806738],
                    ]),
        "256_dense": dict(initial_cost=25668.25144509, final_cost=7.711922555371, iterations=12,
                    nodes=[0, 32, 64, 96, 128, 160, 192, 224, 255], poses=[
                    [40.74366543153, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
                    [20.66409864005, 20.69155333008, 0.08906244481695, 0.001060068506521, 0.0004603637089488,
                     0.3771521455617, 0.9261505943518],
                    [-0.2890895649234, 0.7831835110543, 0.06843688905536, 0.001952568818968, 0.0008682146761544,
                     0.7017759581391, 0.7123945102654],
                    [19.66473543836, -20.2540335188, 0.003468711858122, 0.00251378229059, 0.001122818610249,
                     0.9228590383322, 0.3851280508422],
                    [40.3517367986, -0.2350181124439, -0.0830127050712, 0.00270791942219, 0.001193334890776,
                     0.999995533232, 0.0004202859709682],
                    [20.32641837509, 20.4187586169, -0.05393894591789, 0.002514221619736, 0.001093651481311,
                     0.9245331203857, -0.3810918418519],
                    [-0.220148731449, 0.3389689350161, 0.06578089436109, 0.001944827726934, 0.000835689400065,
                     0.7072061779876, -0.7070042016031],
                    [20.07535300108, -20.24462708184, 0.08966996365627, 0.001054745704213, 0.0004533246857813,
                     0.3805663824158, -0.9247528916328],
                    [40.69195748801, -0.998509254524, -0.009759411773967, 3.361415099668e-05, 1.41194969512e-05,
                     0.01214118832864, -0.9999262923919],
                    ]),
        "256_pcg": dict(initial_cost=25668.25144509, final_cost=9.353140702159, iterations=12,
                    nodes=[0, 32, 64, 96, 128, 160, 192, 224, 255], poses=[
                    [40.74366543153, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
                    [21.21888704248, 22.374450238, 0.04522127324153, -0.002297598516819, -0.004670000518224,
                     0.2725452175588, 0.9621288980807],
                    [-7.620197297559, 12.77434188327, 0.05303269986968, 0.0004905085121933, 0.009810396733159,
                     0.4502228572884, 0.8928621922181],
                    [-2.215172463503, -14.80004901474, -0.2094868821642, 0.01128623242333, -0.01049299185378,
                     0.8243979317834, 0.5658008202105],
                    [20.42809501988, -0.2607187486134, 0.197211475846, -0.01037766456226, 0.003072031910346,
                     0.9999355640822, -0.003425548397989],
                    [-1.786608301302, 14.98366221974, -0.20984931473, 0.01457954921692, 0.009222668589832,
                     0.8227568825527, -0.5681315792498],
                    [-8.008332679929, -12.08379865217, 0.06410242523381, -0.001999710952947, -0.01019504280788,
                     0.45330475539, -0.8912950471079],
                    [20.67757691783, -22.12966833609, 0.07112412426843, -0.00267141689088, 0.008162591908121,
                     0.2765797514845, -0.9609525881613],
                    [40.68524404071, -0.9988876811442, -0.007157591519799, 0.001228214369424, -0.0002257415750601,
                     0.01491286928634, -0.9998880171598],
                    ]),
    },
    loop=dict(events=[dict(query_id=20, candidate_id=0, score=1.0, num_inliers=400, accepted=True)],
              vio_error_m=0.5, corrected_error_m=0.0106407348608,
              live_corrected_error_m=0.0106407348608,
              corrected_position=[0.008386469123032, 0.006549226979293, 1.134322068398e-14]),
    runtime=dict(frames_tracked=27, keyframes=18, nodes=18, events=3, accepted=2,
                 queries=[(None, 0.0)] * 3 + [(1, 0.0)] * 12 + [(110, 0.29729729890823364), (110, 1.0), (163, 1.0)],
                 event_list=[dict(query_id=443, candidate_id=110, score=0.29729729890823364, num_inliers=10,
                                  accepted=False),
                             dict(query_id=499, candidate_id=110, score=1.0, num_inliers=39, accepted=True),
                             dict(query_id=538, candidate_id=163, score=1.0, num_inliers=36, accepted=True)],
                 loop_edges=[dict(translation_m=0.016145441872306033, rotation_rad=0.002498261834416883),
                             dict(translation_m=0.0021106076221809483, rotation_rad=0.003780620578808046)]),
)
# Gates: pgo against the JAX reading to pgo_rel relative (costs; poses
# relative to the circle's radius), the dense and PCG solves as
# tests/test_posegraph.py:69-86 holds them; the loop's corrected error below
# loop_error_ratio of the VIO error (the JAX test's bound) and within
# loop_vs_jax_m of the JAX reading's corrected position, its inliers
# equal; the runtime's accepted loops' edges within rel_pose_m /
# rel_pose_rad of the VIO relative pose, at least one loop accepted, its
# loop events and accepted loops within one of the JAX float32 CPU
# reading's 3 and 2 (the first event's score sits at 11 of 37 votes, by
# 0.08 over the 0.22 threshold, and its verification's inliers at 10 of
# 20, so a float32 difference may add or drop an event or a loop).
POSEGRAPH_GATES = dict(pgo_rel=1e-6, dense_pcg_cost=1.001, loop_error_ratio=0.3, loop_vs_jax_m=1e-6,
                       rel_pose_m=0.05, rel_pose_rad=0.02, events_margin=1, accepted_margin=1)


def pgo_reading(res, n: int) -> dict:
    """Costs, iterations and the sampled nodes (`nodes`) and their poses of
    a solve."""
    idx = sorted(set(range(0, n, n // POSEGRAPH_SAMPLES)) | {n - 1})
    # a result of either package: torch tensors or JAX arrays
    r, q = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64) for x in (res.node_r, res.node_q))
    return dict(initial_cost=float(res.initial_cost), final_cost=float(res.final_cost),
                iterations=int(res.iterations), nodes=idx, poses=np.concatenate([r[idx], q[idx]], 1).tolist())


def pgo_fails(got: dict, ref: dict, radius: float, what: str) -> list:
    rel = POSEGRAPH_GATES["pgo_rel"]
    fails = [f"{what} {k} {got[k]} against the JAX reading's {ref[k]}" for k in ("initial_cost", "final_cost")
             if abs(got[k] - ref[k]) > rel * abs(ref[k])]
    if got["iterations"] != ref["iterations"]:
        fails.append(f"{what} {got['iterations']} iterations against the JAX reading's {ref['iterations']}")
    dp = np.abs(np.asarray(got["poses"]) - np.asarray(ref["poses"]))
    if dp[:, :3].max() > rel * radius or dp[:, 3:].max() > rel:
        fails.append(f"{what} poses off the JAX reading by {dp.max()}")
    return fails


def check_posegraph_pgo(dev: str) -> dict:
    """The pgo part: each circle solved (twice, for bitwise equality), timed
    and profiled; the dense and PCG paths against each other. Returns the
    part's line."""
    import torch

    from okvis_tpu_torch.datasets.synthetic import circle_pose_graph, fill_pose_graph
    from okvis_tpu_torch.posegraph import optimize as pgo
    from okvis_tpu_torch.posegraph.graph import PoseGraph

    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    cfg = POSEGRAPH_PGO
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    line, fails = dict(dtype="float64"), []
    harris_suppressed_cuda.launches = 0
    hamming_matrix_cuda.launches = 0
    for n in cfg["nodes"]:
        spec = circle_pose_graph(n)
        graph = fill_pose_graph(PoseGraph(n, 2 * n, device=dev), spec)
        arrays = graph.to_arrays()
        kw = dict(max_iterations=cfg["max_iterations"], pcg_iters=cfg["pcg_iters"])
        solve = lambda: pgo.optimize_pose_graph(arrays, **kw)  # noqa: E731
        runs = [solve(), solve()]
        same = all(torch.equal(getattr(runs[0], k), getattr(runs[1], k)) for k in runs[0]._fields)
        gauge = bool(torch.equal(runs[0].node_r[0], arrays.node_r[0]) and torch.equal(runs[0].node_q[0],
                                                                                      arrays.node_q[0]))
        ms = []
        for _ in range(cfg["reps"]):
            sync()
            t0 = time.perf_counter()
            solve()
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        sync()
        t0 = time.perf_counter()
        graph.optimize(**kw)  # through the container: upload, solve, write back
        container_ms = 1e3 * (time.perf_counter() - t0)
        reading = pgo_reading(runs[0], n)
        entry = dict(edges=n, solver=pgo.resolve_solver(n, "auto"), **kw, **reading,
                     ms=statistics.median(ms), ms_all=ms, container_ms=container_ms, bitwise_equal_rerun=same,
                     gauge_node_unchanged=gauge, jax_cpu_reference={k: JAX_POSEGRAPH["pgo"][str(n)][k]
                                                                     for k in ("initial_cost", "final_cost",
                                                                               "iterations")})
        if dev == "cuda":
            entry["profile"] = profile_call(solve)
        line[str(n)] = entry
        fails += pgo_fails(reading, JAX_POSEGRAPH["pgo"][str(n)], n / (2 * np.pi), f"{n} nodes")
        fails += [f"{n} nodes: the rerun differs"] * (not same) + [f"{n} nodes: the gauge node moved"] * (not gauge)
    n = cfg["compare_nodes"]
    spec = circle_pose_graph(n)
    res = {s: fill_pose_graph(PoseGraph(n, 2 * n, device=dev), spec).optimize(
        max_iterations=cfg["compare_iterations"], pcg_iters=cfg["compare_pcg_iters"], solver=s)
        for s in ("dense", "pcg")}
    d, p = res["dense"], res["pcg"]
    jd, jp = (JAX_POSEGRAPH["pgo"][f"{n}_{s}"] for s in ("dense", "pcg"))
    cmp = dict(graph_nodes=n, iterations=cfg["compare_iterations"], pcg_iters=cfg["compare_pcg_iters"],
               dense=pgo_reading(d, n), pcg=pgo_reading(p, n),
               max_position_gap_m=float((d.node_r - p.node_r).abs().max()),
               jax_max_sampled_position_gap_m=float(np.abs(np.asarray(jd["poses"])[:, :3]
                                                           - np.asarray(jp["poses"])[:, :3]).max()))
    line["dense_vs_pcg"] = cmp
    # tests/test_posegraph.py:69-86's two cost tolerances; its 1e-3 m on the
    # poses does not hold for this graph in the JAX package either, so each
    # solve is held to its JAX reading instead (pgo_fails below)
    if not (float(d.final_cost) <= POSEGRAPH_GATES["dense_pcg_cost"] * float(p.final_cost) + 1e-9
            and abs(float(d.initial_cost) - float(p.initial_cost)) <= 1e-9 * float(p.initial_cost)):
        fails.append(f"dense against PCG at {n} nodes: {cmp}")
    for s in ("dense", "pcg"):
        fails += pgo_fails(cmp[s], JAX_POSEGRAPH["pgo"][f"{n}_{s}"], n / (2 * np.pi), f"{n} nodes {s}")
    # the solver is plain torch (the JAX package's is no Pallas kernel):
    # neither hand kernel is on this path
    line["launches"] = dict(harris_nms=harris_suppressed_cuda.launches, hamming=hamming_matrix_cuda.launches)
    if max(line["launches"].values()):
        fails.append(f"the solves launched a hand kernel: {line['launches']}")
    line["fails"] = fails
    return line


def run_square_loop(dev: str):
    """The loop part's 21 keyframes through a PoseGraphManager on `dev`: per
    keyframe the host ms of add_keyframe (its device reads included) and
    the Hamming launches; the layer's Hamming launches by shape."""
    from okvis_tpu_torch.datasets.synthetic import square_loop_keyframes
    from okvis_tpu_torch.posegraph.manager import PoseGraphConfig, PoseGraphManager

    cfg = POSEGRAPH_LOOP
    kfs = square_loop_keyframes(np.random.default_rng(cfg["seed"]), cfg["landmarks"], words=True)
    mgr = PoseGraphManager(PoseGraphConfig(
        min_gap=cfg["min_gap"], score_threshold=cfg["score_threshold"], min_inliers=cfg["min_inliers"],
        node_capacity=cfg["node_capacity"], edge_capacity=cfg["edge_capacity"], db_kp_capacity=cfg["db_kp_capacity"],
        desc_words=16, desc_dtype=np.uint32), device=dev)
    k = cfg["landmarks"]
    rows, log = [], {}
    with kernel_shapes(log):
        for i, kf in enumerate(kfs):
            h0 = kernel_counts()["hamming"]
            t0 = time.perf_counter()
            mgr.add_keyframe(i, i * 10**8, *kf["vio"], kf["descriptors"], np.ones(k, bool), kf["bearings"],
                             kf["landmarks_W"], np.ones(k, bool))
            rows.append(dict(keyframe=i, ms=1e3 * (time.perf_counter() - t0),
                             hamming=kernel_counts()["hamming"] - h0))
    return mgr, kfs, rows, shapes_of(log).get("hamming", {})


def loop_reading(mgr, kfs) -> dict:
    """The loop's events and the final keyframe's errors."""
    gt, vio = kfs[-1]["gt"], kfs[-1]["vio"]
    r_corr, _ = mgr.graph.get_pose(len(kfs) - 1)
    r_live, _ = mgr.apply_correction(*vio)
    return dict(events=[dict(vars(e)) for e in mgr.loop_events], vio_error_m=float(np.linalg.norm(vio[0] - gt[0])),
                corrected_error_m=float(np.linalg.norm(r_corr - gt[0])),
                live_corrected_error_m=float(np.linalg.norm(r_live - gt[0])), corrected_position=r_corr.tolist())


def check_posegraph_loop(dev: str) -> tuple:
    """The loop part, twice for bitwise equality (keyframe ms from the
    second run: the first pays for the first float64 verification and
    solve of the process); one query timed. Returns the part's line and the
    manager (its database serves the kernel check)."""
    from okvis_tpu_torch import convert
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    harris_suppressed_cuda.launches = 0
    hamming_matrix_cuda.launches = 0
    mgr, kfs, rows, shapes = run_square_loop(dev)
    launches = dict(harris_nms=harris_suppressed_cuda.launches, hamming=hamming_matrix_cuda.launches)
    mgr2, _, rows2, _ = run_square_loop(dev)
    same = same_values(convert.posegraph_to_numpy(mgr), convert.posegraph_to_numpy(mgr2))
    reading = loop_reading(mgr, kfs)
    q = kfs[-1]["descriptors"]
    mask = np.ones(len(q), bool)
    exclude = set(mgr.insert_order[-mgr.cfg.min_gap:])
    query_ms = []
    for _ in range(POSEGRAPH_LOOP["query_reps"]):
        t0 = time.perf_counter()
        mgr.db.query(q, mask, exclude)
        query_ms.append(1e3 * (time.perf_counter() - t0))
    ref = JAX_POSEGRAPH["loop"]
    line = dict(**{k: v for k, v in POSEGRAPH_LOOP.items() if k != "query_reps"}, keyframes=len(kfs),
                database_shape=[mgr.db.kp_cap, mgr.db.frame_cap * mgr.db.kp_cap], **reading,
                hamming_per_keyframe=[r["hamming"] for r in rows], launches=launches, hamming_by_shape=shapes,
                keyframe_ms=[r["ms"] for r in rows2], keyframe_ms_first_run=[r["ms"] for r in rows],
                query_ms=dict(median=statistics.median(query_ms), all=query_ms),
                bitwise_equal_rerun=same, jax_cpu_reference=ref)
    accepted = [e for e in mgr.loop_events if e.accepted]
    fails = []
    if [e.candidate_id for e in accepted] != [0]:
        fails.append(f"accepted loops {reading['events']} (want one, to keyframe 0)")
    if not reading["corrected_error_m"] < POSEGRAPH_GATES["loop_error_ratio"] * reading["vio_error_m"]:
        fails.append(f"corrected error {reading['corrected_error_m']} against VIO {reading['vio_error_m']}")
    gap = float(np.linalg.norm(np.asarray(reading["corrected_position"]) - np.asarray(ref["corrected_position"])))
    line["corrected_position_gap_to_jax_m"] = gap
    if gap > POSEGRAPH_GATES["loop_vs_jax_m"]:
        fails.append(f"corrected position {gap} m off the JAX reading")
    if [e["num_inliers"] for e in reading["events"]] != [e["num_inliers"] for e in ref["events"]]:
        fails.append(f"inliers {reading['events']} against the JAX reading's {ref['events']}")
    if not same:
        fails.append("the rerun differs")
    # the manager detects nothing: Hamming only, each launch at a shape of
    # the layer
    if launches["harris_nms"] or not launches["hamming"] or sum(shapes.values()) != launches["hamming"]:
        fails.append(f"launches {launches}, by shape {shapes}")
    line["fails"] = fails
    return line, mgr


def loop_edge_errors(mgr) -> list:
    """Each accepted loop's edge against the VIO relative pose of its two
    keyframes: (translation m, rotation rad)."""
    from okvis_tpu_torch.kinematics import np_se3

    g, out = mgr.graph, []
    for e in np.nonzero(g.edge_mask[: g.n_edges] & (g.edge_kind[: g.n_edges] == 1))[0]:
        a, b = g.id_of[int(g.edge_i[e])], g.id_of[int(g.edge_j[e])]
        r, q = np_se3.relative(*mgr.vio_pose_of[a], *mgr.vio_pose_of[b])
        dq = np_se3.quat_multiply(g.meas_q[e], np_se3.quat_conjugate(q))
        out.append(dict(candidate=a, query=b, translation_m=float(np.linalg.norm(g.meas_r[e] - r)),
                        rotation_rad=float(2 * np.arcsin(min(1.0, np.linalg.norm(dq[:3]))))))
    return out


def check_posegraph_runtime(dev: str) -> dict:
    """The runtime part: revisit_scene's frames through ThreadedVio with the
    pose graph on, then without it (mode "runtime": the same rig and
    parameters); the states of the two runs bit for bit, the loop events,
    accepted loops and loop edges against the JAX float32 CPU reading, the
    kernels of the path counted around the first run. Returns the part's
    line."""
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    scene = revisit_scene()
    harris_suppressed_cuda.launches = 0
    hamming_matrix_cuda.launches = 0
    run = run_runtime(scene, dev, "posegraph")
    launches = dict(harris_nms=harris_suppressed_cuda.launches, hamming=hamming_matrix_cuda.launches)
    result = runtime_result(run, scene.traj)
    plain = run_runtime(scene, dev)
    plain_result = runtime_result(plain, scene.traj)
    mgr = run.vio.posegraph
    same = {k: bool(np.array_equal(v, plain_result["arrays"][k])) for k, v in result["arrays"].items()}
    frame_ms = [r["frame_ms"] for r in run.rows[2:]]
    plain_ms = [r["frame_ms"] for r in plain.rows[2:]]
    feeds, shapes = run.posegraph_feeds, shapes_of(run.posegraph_shapes).get("hamming", {})
    events = [dict(vars(e)) for e in mgr.loop_events]
    ref, gates = JAX_POSEGRAPH["runtime"], POSEGRAPH_GATES
    line = dict(**POSEGRAPH_RUNTIME, frames_fed=run.frames_fed, dtype="float32 (estimator), float64 (pose graph)",
                ate_m=result["ate_m"], keyframes=result["keyframes"],
                keyframe_frames=[r["frame"] for r in run.rows if r["keyframe"]], nodes=mgr.graph.n_nodes,
                edges=int(mgr.graph.edge_mask.sum()), queries=run.posegraph_queries, events=events,
                accepted=sum(e["accepted"] for e in events), callbacks=len(run.loop_callbacks),
                loop_edges=loop_edge_errors(mgr), stage=run.stages.get("3.3 posegraph"), launches=launches,
                hamming_per_keyframe=feeds, hamming_by_shape=shapes,
                frame_ms=dict(median=statistics.median(frame_ms), max=max(frame_ms)),
                frame_ms_without_posegraph=dict(median=statistics.median(plain_ms), max=max(plain_ms)),
                frame_ms_all=[r["frame_ms"] for r in run.rows], harris_per_frame=sorted({r["harris"] for r in run.rows}),
                equal_to_run_without_posegraph=same, frames_processed=run.frames_processed,
                jax_cpu_reference=ref)
    fails = []
    if not all(same.values()):
        fails.append(f"states differ from the run without the pose graph: {same}")
    if mgr.graph.n_nodes != result["keyframes"] or len(feeds) != result["keyframes"]:
        fails.append(f"{mgr.graph.n_nodes} nodes, {len(feeds)} feeds for {result['keyframes']} keyframes")
    if abs(len(events) - ref["events"]) > gates["events_margin"]:
        fails.append(f"{len(events)} loop events (JAX float32 CPU run: {ref['events']})")
    if not line["accepted"] or abs(line["accepted"] - ref["accepted"]) > gates["accepted_margin"]:
        fails.append(f"{line['accepted']} accepted loops (JAX float32 CPU run: {ref['accepted']})")
    if line["callbacks"] != line["accepted"] or len(line["loop_edges"]) != line["accepted"]:
        fails.append(f"{line['callbacks']} callbacks, {len(line['loop_edges'])} loop edges "
                     f"for {line['accepted']} accepted loops")
    bad = [e for e in line["loop_edges"] if e["translation_m"] > gates["rel_pose_m"]
           or e["rotation_rad"] > gates["rel_pose_rad"]]
    if bad:
        fails.append(f"loop edges off the VIO relative pose: {bad}")
    if not sum(feeds) or sum(shapes.values()) != sum(feeds):
        fails.append(f"Hamming launches in the pose-graph layer: {sum(feeds)}, by shape {shapes}")
    if line["harris_per_frame"] != [1] or min(launches.values()) == 0:
        fails.append(f"kernels of the path: {launches}, Harris a frame {line['harris_per_frame']}")
    if run.frames_processed != run.frames_fed or plain.frames_processed != plain.frames_fed:
        fails.append(f"{run.frames_processed}, {plain.frames_processed} of {run.frames_fed} frames processed")
    line["fails"] = fails
    return line


def database_kernel_entry(mgr, by_path: dict) -> dict:
    """The Hamming kernel at the loop part's database shape (400, 102,400):
    against its plain version exactly, timed beside it and beside the ±1
    float32 torch.matmul, with its bound; `by_path` is each part's line,
    whose pose-graph launches by shape it carries, with their database-shape
    launches a keyframe. These launches come after the parts' counts were
    read."""
    import torch

    from okvis_tpu_torch.ops.hamming import masked_distance_matrix_plain, unpack_to_pm1
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda
    from okvis_tpu_torch.posegraph.place_recognition import as_words

    db = mgr.db
    key = f"{db.kp_cap}x{db.frame_cap * db.kp_cap}"
    per_keyframe = {p: line["hamming_by_shape"].get(key, 0) / line["keyframes"] for p, line in by_path.items()}
    a = torch.from_numpy(as_words(db.desc[db.slot_of[0]])).to("cuda")
    b = db.device_desc.reshape(-1, 16)
    mb = db.device_mask.reshape(-1)
    args = (a, b, None, mb)
    dk = hamming_matrix_cuda(*args)
    dp = masked_distance_matrix_plain(*args)
    torch.cuda.synchronize()
    err = int((dk - dp).abs().max())
    na, nb = dk.shape
    n_bytes = (a.numel() + b.numel()) * 4 + mb.numel() + na * nb * 4
    bound_ms, bound_by = bound(n_bytes, *({c: n * na * nb for c, n in r.items()} for r in HAMMING_ROUTES))
    va, vb = unpack_to_pm1(a), unpack_to_pm1(b)
    return dict(shape=[1, na, nb], max_abs_err=err, equal=bool(torch.equal(dk, dp)),
                ms=device_ms(lambda: hamming_matrix_cuda(*args)),
                plain_ms=device_ms(lambda: masked_distance_matrix_plain(*args), reps=3, inner=1),
                library_ms=device_ms(lambda: torch.matmul(va, vb.T)), library="±1 float32 torch.matmul",
                bound_ms=bound_ms, bound_by=bound_by, launches_per_keyframe=per_keyframe,
                launches_by_shape={p: line["hamming_by_shape"] for p, line in by_path.items()})


def check_posegraph(dev: str = "cuda") -> dict:
    """The posegraph phase: runtime, pgo and loop, each printed as a
    `posegraph` line; the Hamming kernel at the database shape. Returns the
    launches a part and the database kernel entry for the `kernels` line."""
    fails, lines = [], {}
    # the runtime part first: its frames follow the modes phase's, as the
    # runtime phase's follow the vio phase's, and no solve or profiler runs
    # before them
    for part, check in (("runtime", check_posegraph_runtime), ("pgo", check_posegraph_pgo),
                        ("loop", check_posegraph_loop)):
        t0 = time.perf_counter()
        lines[part] = check(dev)
        if part == "loop":
            lines[part], mgr = lines[part]
        lines[part]["seconds"] = time.perf_counter() - t0
    for part, line in lines.items():
        print("posegraph", json.dumps(dict(part=part, **line)))
        fails += [f"{part}: {f}" for f in line["fails"]]
    entry = database_kernel_entry(mgr, {p: lines[p] for p in ("loop", "runtime")}) if dev == "cuda" else None
    if entry is not None and (entry["max_abs_err"] or not entry["equal"]):
        fails.append(f"the Hamming kernel differs from its plain version at {entry['shape']}")
    print("posegraph_kernels", json.dumps(dict(database=entry)))
    if fails:
        raise SmokeError("posegraph phase: " + "; ".join(fails))
    return dict(launches={f"posegraph_{p}": lines[p]["launches"] for p in ("pgo", "loop", "runtime")}, database=entry)


# ---------------------------------------------------------------------------
# the app phase: the EuRoC app on a dataset the port writes, and ThreadedVio
# over a textured plane
# ---------------------------------------------------------------------------

# revisit: the posegraph phase's revisiting world (datasets.synthetic.
# revisit_world, POSEGRAPH_RUNTIME's frames and period) written by the port's
# write_euroc_format at the EuRoC rig (2 x 752x480) on the CPU in float64,
# then apps.run_euroc.run on the card in float32 with loop closure, the
# posegraph runtime part's parameters built in code (400 keypoints,
# threshold 40, min_gap 2) and the zlib+numpy PNG decoder; run again with the
# native decoder where it builds (else the same decoder again).
# textured: tests/test_vision_textured.py's flight (trajectory seed 81,
# motion_scale 0.2, 3 m above the plane with a 180° roll, plane_scale 150,
# 12 frames, 200 keypoints, threshold 25) over datasets.synthetic.
# noise_texture (1,024 x 1,024, seed texture_seed), rendered by the port's
# render_textured_plane and fed to ThreadedVio as the JAX test feeds it,
# with timestamps rounded to the ns (utils.time.ns_from_sec), twice.
APP_DECODER = "python"  # the first run's decoder: png.py, which needs no libpng
APP_TEXTURED = dict(traj_seed=81, motion_scale=0.2, duration=1.6, height=3.0, plane_scale=150.0, frames=12,
                    keypoints=200, threshold=25.0, texture_size=1024, texture_seed=7)
# sha256 of the revisit dataset (app_dataset_digest) as the port writes it
# on the CPU of the machine the readings were taken on: its content (the
# CSV files' bytes and every PNG's decoded grey levels) does not depend on
# the machine. The PNG files' own bytes also depend on the zlib library that
# compressed them, so their digest is printed beside it, with zlib's version,
# and not gated.
APP_DATASET_SHA256 = "0f31a8fb5aa5a49b6801d8bea34f7b85a47c2eb357c23f601effc373d5051a83"
# The JAX package on the CPU in float32 (scripts/jax_app.py; a CPU run, not a
# device metric): its own write_euroc_format and run_euroc.run on the
# revisit world (a YAML written from the same parameters), and its
# render_textured_plane and ThreadedVio on the textured flight.
JAX_APP = dict(
    revisit=dict(frames_processed=27, frames_fed=27, ate_rmse_m=0.008293571757581377, loop_closures=1,
                 posegraph_keyframes=19, ate_rmse_loop_m=0.00920746573328982,
                 events=[dict(query_id=545, candidate_id=122, score=0.976190447807312, num_inliers=35, accepted=True)],
                 loop_edges=[dict(translation_m=0.021004564725174393, rotation_rad=0.008891595017244996)]),
    textured=dict(frames=12, frames_tracked=12, ate_m=0.03486934109005981, landmarks=187, keyframes=1),
)
# Gates: revisit: every frame fed processed, the ATE within ate_margin_m of
# the JAX reading, loop closures and pose-graph keyframes within one of it,
# every accepted loop edge within 0.05 m / 0.02 rad of the VIO relative
# pose, the second run's TUM files byte for byte the first's; textured: the
# JAX test's bounds (frames, ATE, landmarks) and the rerun's trajectory.
APP_GATES = dict(ate_margin_m=0.003, loops_margin=1, keyframes_margin=1, rel_pose_m=0.05, rel_pose_rad=0.02,
                 textured_frames=10, textured_ate_m=0.15, textured_landmarks=30)


_SHAPE_LOGS = []  # the logs kernel_shapes records into, outermost first


@contextlib.contextmanager
def kernel_shapes(log: dict):
    """Record every launch of both hand kernels for the length of a run:
    `log` maps (kernel, "AxBxC") to [launches, the last launch's (args,
    kwargs)]. Harris is keyed by its (C, H, W) input, Hamming by its output
    (G, NA, NB) or (NA, NB). The one launch recorder of the script: a use
    inside another records into both logs (a run's launches and a part of
    it, such as the pose-graph layer's). The wrappers are the modules'
    attributes, which every caller looks up at call time, and so is the
    name whose `launches` a wrapper function counts on: the wrapper carries
    the counter while it is in place, and hands it back after."""
    from okvis_tpu_torch.ops import detection_cuda, hamming_cuda

    _SHAPE_LOGS.append(log)
    if len(_SHAPE_LOGS) > 1:  # the outermost use's wrappers are in place
        try:
            yield log
        finally:
            _SHAPE_LOGS.pop()
        return
    originals = (detection_cuda.harris_suppressed_cuda, hamming_cuda.hamming_matrix_cuda)

    def wrap(name, fn, shape_of):
        def call(*args, **kw):
            n0 = call.launches
            res = fn(*args, **kw)  # counts on call.launches, the module's name
            if call.launches > n0:
                key = (name, "x".join(map(str, shape_of(args, res))))
                for open_log in _SHAPE_LOGS:
                    entry = open_log.setdefault(key, [0, None])
                    entry[0] += call.launches - n0
                    entry[1] = (args, kw)
            return res
        call.launches = fn.launches
        return call

    wrappers = (wrap("harris_nms", originals[0], lambda a, r: a[0].shape),
                wrap("hamming", originals[1], lambda a, r: r.shape))
    detection_cuda.harris_suppressed_cuda, hamming_cuda.hamming_matrix_cuda = wrappers
    try:
        yield log
    finally:
        _SHAPE_LOGS.pop()
        detection_cuda.harris_suppressed_cuda, hamming_cuda.hamming_matrix_cuda = originals
        for fn, w in zip(originals, wrappers):
            fn.launches = w.launches


def kernel_counts() -> dict:
    """Both hand kernels' launches so far, read through the modules'
    attributes: inside kernel_shapes its wrappers carry the counts."""
    from okvis_tpu_torch.ops import detection_cuda, hamming_cuda

    return dict(harris_nms=detection_cuda.harris_suppressed_cuda.launches,
                hamming=hamming_cuda.hamming_matrix_cuda.launches)


def shapes_of(log: dict, per: int = 1) -> dict:
    """kernel_shapes' launches, {kernel: {shape: launches}}, divided by `per`
    (launches a frame or a keyframe)."""
    out = {}
    for (name, shape), (n, _) in sorted(log.items()):
        out.setdefault(name, {})[shape] = n / per if per != 1 else n
    return out


def shape_count_fails(launches: dict, log: dict) -> list:
    """A kernel of the path launched no time, or launches by shape that do
    not add up to the kernel's count."""
    by = shapes_of(log)
    return [f"{name}: {n} launches, {sum(by.get(name, {}).values())} by shape {by.get(name, {})}"
            for name, n in launches.items() if n == 0 or sum(by.get(name, {}).values()) != n]


def app_params(rig):
    """The revisit part's VioParameters: the posegraph runtime part's
    (modes_params("posegraph")) with the rig's cameras, so the loader reads
    both cameras."""
    from okvis_tpu_torch.config.yaml_writer import cameras_from_rig

    p = modes_params("posegraph")
    p.cameras = cameras_from_rig(rig)
    return p


def app_dataset_digest(mav0: str) -> dict:
    """sha256 over the relative path of every file under mav0 and its
    content (a PNG's decoded grey levels, any other file's bytes), and
    sha256 over the paths and the files' bytes."""
    import hashlib
    import os
    import zlib

    from okvis_tpu_torch.datasets.png import read_png_gray

    content, files = hashlib.sha256(), hashlib.sha256()
    names = sorted(os.path.relpath(os.path.join(d, f), mav0) for d, _, fs in os.walk(mav0) for f in fs)
    for name in names:
        path = os.path.join(mav0, name)
        with open(path, "rb") as f:
            data = f.read()
        for h in (content, files):
            h.update(name.encode())
        files.update(data)
        content.update(read_png_gray(path).astype(np.uint8).tobytes() if name.endswith(".png") else data)
    return dict(content=content.hexdigest(), files=files.hexdigest(), zlib=zlib.ZLIB_RUNTIME_VERSION)


def write_app_dataset(directory: str) -> dict:
    """The revisit world written in the EuRoC layout under `directory`;
    the time it took a written image (rendering included) and the PNG
    encoding alone."""
    import os

    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.png import read_png_gray, write_png_gray
    from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, revisit_world, write_euroc_format

    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    rig = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)
    n = POSEGRAPH_RUNTIME["frames"]
    traj, lms = revisit_world(n, POSEGRAPH_RUNTIME["period"])
    t0 = time.perf_counter()
    mav0 = write_euroc_format(directory, traj, lms, rig, frame_dt=0.1, n_frames=n)
    write_ms = 1e3 * (time.perf_counter() - t0) / (2 * n)
    img = read_png_gray(os.path.join(mav0, "cam0", "data", sorted(os.listdir(os.path.join(mav0, "cam0", "data")))[0]))
    encode_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        write_png_gray(f"{directory}/encode.png", img.astype(np.uint8))
        encode_ms.append(1e3 * (time.perf_counter() - t0))
    return dict(mav0=mav0, traj=traj, images=2 * n, write_ms_per_image=write_ms,
                png_encode_ms=statistics.median(encode_ms), sha256=app_dataset_digest(mav0))


def decode_all(mav0: str, decoder: str) -> tuple:
    """Every image of the dataset through one decoder: the images and the ms
    each took."""
    from okvis_tpu_torch.datasets.euroc import EurocDataset

    ds = EurocDataset(mav0, num_cameras=2, decoder=decoder)
    images, ms = [], []
    for ev in ds.images:
        t0 = time.perf_counter()
        images.append(ev.load())
        ms.append(1e3 * (time.perf_counter() - t0))
    assert set(ds.decoder_used.values()) == {decoder}, ds.decoder_used
    return images, ms


def run_app(mav0: str, out_dir: str, dev: str, decoder: str) -> SimpleNamespace:
    """apps.run_euroc.run on the dataset, with its ThreadedVio recorded: the
    pipeline itself (for its pose graph), the host time of each published
    state, and the launches of both kernels by shape."""
    import torch

    from okvis_tpu_torch.apps import run_euroc
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda
    from okvis_tpu_torch.utils.ids import IdProvider
    from okvis_tpu_torch.utils.timing import Timing

    rig = modes_rig("runtime", dev)
    rec = SimpleNamespace(vio=None, published=[], shapes={})
    base = run_euroc.ThreadedVio

    class Recorded(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            rec.vio = self
            self.state_callback = lambda t, T: rec.published.append(time.perf_counter())

    IdProvider.reset()
    Timing.reset()
    harris_suppressed_cuda.launches = 0
    hamming_matrix_cuda.launches = 0
    run_euroc.ThreadedVio = Recorded
    try:
        with kernel_shapes(rec.shapes):
            rec.out = run_euroc.run(app_params(rig), mav0, dtype=torch.float32, trajectory_out=f"{out_dir}/app.tum",
                                    rig=rig, loop_closure=True, device=dev, decoder=decoder)
    finally:
        run_euroc.ThreadedVio = base
    rec.launches = dict(harris_nms=harris_suppressed_cuda.launches, hamming=hamming_matrix_cuda.launches)
    rec.stages = {name: dict(count=acc.count, mean_ms=1e3 * acc.mean, min_ms=1e3 * acc.min, max_ms=1e3 * acc.max)
                  for name, acc in Timing._timers.items()}
    with open(f"{out_dir}/app.tum", "rb") as f:
        rec.tum = f.read()
    with open(f"{out_dir}/app.tum.loop", "rb") as f:
        rec.loop = f.read()
    return rec


def app_kernel_entries(log: dict) -> list:
    """Each kernel against its plain version on the last arguments the app
    launched it with at each shape: max |difference|, equality (Harris: raw
    bit for bit and the same suppressed values), the kernel's and the plain
    version's device ms and the bound. These launches come after the app's
    counts were read."""
    import torch

    from okvis_tpu_torch.frontend import detection
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming import masked_distance_matrix_plain
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    out = []
    for (name, shape), (n, (args, kw)) in sorted(log.items()):
        if name == "harris_nms":
            raw_k, sup_k = harris_suppressed_cuda(*args, **kw)
            raw_p, sup_p = detection.harris_suppressed_plain(*args, **kw)
            torch.cuda.synchronize()
            fin = torch.isfinite(sup_p)
            equal = (torch.equal(raw_k, raw_p) and torch.equal(torch.isfinite(sup_k), fin)
                     and torch.equal(sup_k[fin], sup_p[fin]))
            err = float((raw_k - raw_p).abs().max())
            px = args[0].numel()
            bound_ms, bound_by = bound(16 * px, {c: k * px for c, k in HARRIS_OPS_PER_PIXEL.items()})
            kernel, plain = (lambda: harris_suppressed_cuda(*args, **kw)), \
                (lambda: detection.harris_suppressed_plain(*args, **kw))
            library = None
        else:
            dk = hamming_matrix_cuda(*args, **kw)
            dp = masked_distance_matrix_plain(*args, **kw)
            torch.cuda.synchronize()
            equal, err = bool(torch.equal(dk, dp)), int((dk - dp).abs().max()) if dk.numel() else 0
            outputs = dk.numel()
            n_bytes = sum(x.numel() * x.element_size() for x in args if x is not None) + 4 * outputs
            bound_ms, bound_by = bound(n_bytes, *({c: k * outputs for c, k in r.items()} for r in HAMMING_ROUTES))
            kernel, plain = (lambda: hamming_matrix_cuda(*args, **kw)), \
                (lambda: masked_distance_matrix_plain(*args, **kw))
            library = pm1_product(args[0], args[1], dk.shape)
        out.append(dict(kernel=name, shape=shape, launches=n, equal=equal, max_abs_err=err,
                        ms=device_ms(kernel, reps=5), plain_ms=device_ms(plain, reps=3, inner=1),
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None if library is None else device_ms(library, reps=5),
                        library=None if library is None else ("±1 float32 torch.matmul" if len(dk.shape) == 2
                                                              else "±1 float32 torch.bmm")))
    return out


def pm1_product(desc_a, desc_b, shape):
    """The library yardstick of a Hamming launch: the ±1 float32 product of
    the unpacked descriptors (torch.matmul for (NA, NB), torch.bmm for
    (G, NA, NB), a batch of 1 broadcast), as a call."""
    import torch

    from okvis_tpu_torch.ops.hamming import unpack_to_pm1

    va, vb = (unpack_to_pm1(x.reshape(-1, 16)).reshape(*x.shape[:-1], 512) for x in (desc_a, desc_b))
    if len(shape) == 2:
        return lambda: torch.matmul(va, vb.T)
    g = shape[0]
    va, vb = (x.reshape(-1, *x.shape[-2:]).expand(g, -1, -1) for x in (va, vb))
    return lambda: torch.bmm(va, vb.transpose(1, 2))


def check_app_revisit(dev: str, tmp: str) -> tuple:
    """The revisit part: returns its line and the kernel shapes' log."""
    import os

    from okvis_tpu_torch import native
    from okvis_tpu_torch.eval.ate import ate_rmse

    t0 = time.perf_counter()
    data = write_app_dataset(f"{tmp}/dataset")
    write_s = time.perf_counter() - t0
    mav0 = data["mav0"]
    py_images, py_ms = decode_all(mav0, "python")
    second, native_line = "python", dict(built=False)
    try:
        native.get_lib()
    except native.NativeUnavailable as e:
        print("app_native_build_error", json.dumps(str(e)))
    else:
        nat_images, nat_ms = decode_all(mav0, "native")
        same = all(np.array_equal(a, b) for a, b in zip(py_images, nat_images))
        native_line = dict(built=True, images_equal_python=same, decode_ms=dict(median=statistics.median(nat_ms),
                                                                                 max=max(nat_ms)))
        second = "native"
    runs = []
    for i, decoder in enumerate((APP_DECODER, second)):
        os.makedirs(f"{tmp}/run{i}", exist_ok=True)
        runs.append(run_app(mav0, f"{tmp}/run{i}", dev, decoder))
    run = runs[0]
    out, mgr = run.out, run.vio.posegraph

    def frame_ms(r):
        gaps = np.diff(r.published)[2:] * 1e3
        return dict(median=float(np.median(gaps)), max=float(gaps.max()))
    events = [dict(vars(e)) for e in mgr.loop_events]
    line = dict(part="revisit", frames=POSEGRAPH_RUNTIME["frames"], rig="2 x 752x480", keypoints=VIO_KEYPOINTS,
                dtype="float32 (estimator), float64 (pose graph)", min_gap=POSEGRAPH_RUNTIME["min_gap"],
                decoder=APP_DECODER, second_run_decoder=second,
                **{k: out[k] for k in ("frames_fed", "frames_processed", "frames_per_s", "wall_s", "ate_rmse_m",
                                       "ate_rmse_loop_m", "loop_closures", "posegraph_keyframes", "decoder_used")},
                frame_ms=dict(frame_ms(run), note="host ms between successive optimized states, from the third on"),
                stages=run.stages, events=events, loop_edges=loop_edge_errors(mgr),
                decode_ms=dict(median=statistics.median(py_ms), max=max(py_ms)), native=native_line,
                write_ms_per_image=data["write_ms_per_image"], png_encode_ms=data["png_encode_ms"],
                write_seconds=write_s, dataset_sha256=data["sha256"], expected_content_sha256=APP_DATASET_SHA256,
                launches=run.launches, launches_by_shape=shapes_of(run.shapes),
                rerun_tum_equal=runs[1].tum == run.tum, rerun_loop_tum_equal=runs[1].loop == run.loop,
                second_run=dict(frame_ms=frame_ms(runs[1]), stages=runs[1].stages,
                                **{k: runs[1].out[k] for k in ("ate_rmse_m", "loop_closures", "frames_per_s", "wall_s",
                                                               "decoder_used")}),
                jax_cpu_reference=JAX_APP["revisit"])
    # the card's own ATE of the .tum file, as a user's evaluator would read it
    rows = np.loadtxt(io.BytesIO(run.tum))
    gt_ts = (data["traj"].ts * 1e9).astype(np.int64) + 1_400_000_000_000_000_000
    line["ate_from_tum_m"] = ate_rmse(np.round(rows[:, 0] * 1e9).astype(np.int64), rows[:, 1:4], gt_ts,
                                      data["traj"].r)
    fails = []
    if data["sha256"]["content"] != APP_DATASET_SHA256:
        fails.append(f"dataset content sha256 {data['sha256']['content']} (the sandbox's CPU: {APP_DATASET_SHA256})")
    if out["frames_processed"] != out["frames_fed"] or out["frames_fed"] != POSEGRAPH_RUNTIME["frames"]:
        fails.append(f"{out['frames_processed']} of {out['frames_fed']} frames processed")
    ref, gates = JAX_APP["revisit"], APP_GATES
    if out["ate_rmse_m"] is None or out["ate_rmse_m"] > ref["ate_rmse_m"] + gates["ate_margin_m"]:
        fails.append(f"ATE {out['ate_rmse_m']} against the JAX float32 CPU run's {ref['ate_rmse_m']}")
    if abs(out["loop_closures"] - ref["loop_closures"]) > gates["loops_margin"] or not out["loop_closures"]:
        fails.append(f"{out['loop_closures']} loop closures (JAX float32 CPU run: {ref['loop_closures']})")
    if abs(out["posegraph_keyframes"] - ref["posegraph_keyframes"]) > gates["keyframes_margin"]:
        fails.append(f"{out['posegraph_keyframes']} pose-graph keyframes (JAX: {ref['posegraph_keyframes']})")
    bad = [e for e in line["loop_edges"] if e["translation_m"] > gates["rel_pose_m"]
           or e["rotation_rad"] > gates["rel_pose_rad"]]
    if bad or len(line["loop_edges"]) != out["loop_closures"]:
        fails.append(f"loop edges {line['loop_edges']} for {out['loop_closures']} loop closures")
    if not (line["rerun_tum_equal"] and line["rerun_loop_tum_equal"]):
        fails.append("the second run's TUM files differ from the first's")
    if native_line["built"] and not native_line["images_equal_python"]:
        fails.append("the native decoder's images differ from the python decoder's")
    if out["decoder_used"] != {APP_DECODER: 2 * POSEGRAPH_RUNTIME["frames"]}:
        fails.append(f"decoders used {out['decoder_used']}")
    fails += [f"kernels of the path: {f}" for f in shape_count_fails(run.launches, run.shapes)]
    line["fails"] = fails
    return line, run.shapes


def textured_frames():
    """The textured flight's frames, rendered on the CPU by the port's
    render_textured_plane: (trajectory, frame times, images, ground truth),
    with the IMU in the flipped body frame."""
    import torch

    from okvis_tpu_torch import kinematics as kin
    from okvis_tpu_torch.datasets.synthetic import noise_texture, render_textured_plane, simulate_trajectory

    cfg = APP_TEXTURED
    rig = modes_rig("runtime", "cpu")
    texture = noise_texture(cfg["texture_size"], cfg["texture_seed"])
    traj = simulate_trajectory(duration=cfg["duration"], seed=cfg["traj_seed"], motion_scale=cfg["motion_scale"])
    flip = np.asarray([1.0, -1.0, -1.0])  # the 180° roll about x negates y and z
    q_down = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    frames = []
    for fi in range(cfg["frames"]):
        idx = int(round(fi * 0.1 * 200))
        T_WS = kin.SE3(r=torch.from_numpy(traj.r[idx] + np.asarray([0.0, 0.0, cfg["height"]])),
                       q=kin.quat_multiply(torch.from_numpy(traj.q[idx]), q_down))
        frames.append(dict(t=fi * 0.1, r=T_WS.r.numpy(), images=[
            render_textured_plane(rig.specs[c], rig.intrinsics[c], kin.compose(T_WS, rig.camera_T_SC(c)), texture,
                                  plane_scale=cfg["plane_scale"]) for c in range(2)]))
    return SimpleNamespace(traj=traj, gyro=traj.gyro * flip, acc=traj.acc * flip, frames=frames)


def run_textured(scene, dev: str, tum_path: str) -> dict:
    """The textured flight through ThreadedVio: the JAX test's feed (the IMU
    up to 25 ms past a frame, both images, wait_idle) with timestamps
    rounded to the ns; the trajectory written to `tum_path`."""
    import torch

    from okvis_tpu_torch.config import VioParameters
    from okvis_tpu_torch.eval.ate import ate_rmse, write_tum
    from okvis_tpu_torch.pipeline import ThreadedVio
    from okvis_tpu_torch.utils.ids import IdProvider
    from okvis_tpu_torch.utils.time import ns_from_sec

    cfg = APP_TEXTURED
    params = VioParameters()
    params.optimization.max_num_keypoints = cfg["keypoints"]
    params.optimization.detection_threshold = cfg["threshold"]
    IdProvider.reset()
    vio = ThreadedVio(params, rig=modes_rig("runtime", dev), blocking=True, dtype=torch.float32, device=dev)
    keypoints, frame_ms = [], []
    detect = vio.frontend.detect_and_describe_multi

    def counted(*args, **kw):
        frames = detect(*args, **kw)
        keypoints.append([int(f.mask_np.sum()) for f in frames])
        return frames

    vio.frontend.detect_and_describe_multi = counted
    ts_ns = [int(ns_from_sec(t)) for t in scene.traj.ts]
    imu_i = 0
    try:
        for fr in scene.frames:
            t_ns = int(ns_from_sec(fr["t"]))
            t0 = time.perf_counter()
            while imu_i < len(ts_ns) and ts_ns[imu_i] <= t_ns + 25_000_000:
                vio.add_imu_measurement(ts_ns[imu_i], scene.gyro[imu_i], scene.acc[imu_i])
                imu_i += 1
            for c, image in enumerate(fr["images"]):
                vio.add_image(t_ns, c, image)
            vio.wait_idle(timeout=120)
            frame_ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        vio.shutdown()
    states = vio.trajectory
    est_ts = np.asarray([s.timestamp_ns for s in states], np.int64)
    est_p = np.stack([s.T_WS.r.numpy() for s in states]) if states else np.zeros((0, 3))
    gt_ts = np.asarray([int(ns_from_sec(fr["t"])) for fr in scene.frames], np.int64)
    gt_p = np.stack([fr["r"] for fr in scene.frames])
    write_tum(tum_path, est_ts, est_p, np.stack([s.T_WS.q.numpy() for s in states]) if states else np.zeros((0, 4)))
    with open(tum_path, "rb") as f:
        tum = f.read()
    return dict(frames=len(scene.frames), frames_tracked=len(states), ate_m=ate_rmse(est_ts, est_p, gt_ts, gt_p),
                landmarks=vio.estimator.num_landmarks(), keyframes=sum(s.is_keyframe for s in states),
                keypoints_per_frame=keypoints, frame_ms=frame_ms, tum=tum)


def check_app_textured(dev: str) -> tuple:
    """The textured part: the flight rendered once, run twice. Returns its
    line and the kernel shapes' log of the first run."""
    import tempfile

    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    t0 = time.perf_counter()
    scene = textured_frames()
    render_s = time.perf_counter() - t0
    harris_suppressed_cuda.launches = 0
    hamming_matrix_cuda.launches = 0
    shapes = {}
    with tempfile.TemporaryDirectory() as tmp:
        with kernel_shapes(shapes):
            first = run_textured(scene, dev, f"{tmp}/first.tum")
        launches = dict(harris_nms=harris_suppressed_cuda.launches, hamming=hamming_matrix_cuda.launches)
        second = run_textured(scene, dev, f"{tmp}/second.tum")
    kp = np.asarray(first["keypoints_per_frame"])
    ms = first["frame_ms"][2:]
    line = dict(part="textured", **{k: v for k, v in APP_TEXTURED.items() if k != "frames"},
                texture="datasets.synthetic.noise_texture", render_seconds=render_s,
                **{k: first[k] for k in ("frames", "frames_tracked", "ate_m", "landmarks", "keyframes")},
                keypoints_per_frame=dict(mean=float(kp.mean()), min=int(kp.min()), max=int(kp.max())),
                frame_ms=dict(median=statistics.median(ms), max=max(ms)), launches=launches,
                launches_by_shape=shapes_of(shapes), rerun_tum_equal=first["tum"] == second["tum"],
                jax_cpu_reference=JAX_APP["textured"])
    ref, gates = JAX_APP["textured"], APP_GATES
    # the JAX test's bounds, or the JAX package's own reading where it
    # misses one of them on this texture
    want_frames = min(gates["textured_frames"], ref["frames_tracked"])
    want_ate = max(gates["textured_ate_m"], ref["ate_m"] + gates["ate_margin_m"])
    want_landmarks = min(gates["textured_landmarks"], ref["landmarks"] - 1)
    fails = []
    if first["frames_tracked"] < want_frames:
        fails.append(f"{first['frames_tracked']} of {first['frames']} frames tracked (want {want_frames})")
    if first["ate_m"] is None or first["ate_m"] >= want_ate:
        fails.append(f"ATE {first['ate_m']} (bound {want_ate})")
    if first["landmarks"] <= want_landmarks:
        fails.append(f"{first['landmarks']} landmarks (want more than {want_landmarks})")
    if not line["rerun_tum_equal"]:
        fails.append("the rerun's trajectory differs")
    fails += [f"kernels of the path: {f}" for f in shape_count_fails(launches, shapes)]
    line["fails"] = fails
    return line, shapes


def check_app(dev: str = "cuda") -> dict:
    """The app phase: the revisit part (the EuRoC app) and the textured
    part, each with its kernels held to their plain versions at every shape
    it launched them at. Prints an `app` line a part and the kernel entries
    of each (`app_kernels`, `app_textured_kernels`); returns the launches
    and kernel entries for the `kernels` line."""
    import tempfile

    fails = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        revisit, log = check_app_revisit(dev, tmp)
        revisit["seconds"] = time.perf_counter() - t0
        print("app", json.dumps(revisit))
        entries = app_kernel_entries(log) if dev == "cuda" else []
        del log
    print("app_kernels", json.dumps(entries))
    t0 = time.perf_counter()
    textured, log = check_app_textured(dev)
    textured["seconds"] = time.perf_counter() - t0
    print("app", json.dumps(textured))
    textured_entries = app_kernel_entries(log) if dev == "cuda" else []
    del log
    print("app_textured_kernels", json.dumps(textured_entries))
    fails += [f"revisit: {f}" for f in revisit["fails"]] + [f"textured: {f}" for f in textured["fails"]]
    fails += [f"{part}: {e['kernel']} at {e['shape']} differs from its plain version"
              for part, es in (("revisit", entries), ("textured", textured_entries)) for e in es if not e["equal"]]
    if fails:
        raise SmokeError("app phase: " + "; ".join(fails))
    return dict(launches=dict(app=revisit["launches"], app_textured=textured["launches"]),
                entries=dict(app_by_shape=entries, app_textured_by_shape=textured_entries))


# ---------------------------------------------------------------------------
# the distributed phase: the batched and sharded BA (okvis_tpu_torch.parallel,
# solver.optimize_windows_batched) and ThreadedVio with a sharded window
# ---------------------------------------------------------------------------

# sharded: BACKEND_WINDOW perturbed as the back-end phase perturbs it, in
# float64, solved by make_sharded_optimizer on one-card meshes of each of
# `shards` shards (all on cuda:0) and on make_mesh2d(*mesh2d), each held to
# the card's float64 optimize_window at SHARDED_TOL; in float32 at
# f32_shards shards, held to that float64 reading and to ground truth by
# OPTIMIZE_GATES["optimize"]. The window's landmark slots are laid out round
# robin over the shard blocks, as Estimator.enable_distributed hands slots
# out (build_ba_problem fills them in order, and at 8 shards in order
# shard_problem sheds 8 of the 1,250 observations over shard 6's block; the
# line prints that count too). two_process: tests/torch_multiproc_worker.py's
# world (L = 64, O = 256) on make_mesh2d(2, 2) across two processes joined by
# torch.distributed over gloo with every shard on cuda:0, held to the
# single-device solve to 1e-8. batched: optimize_windows_batched over the
# first B of max(batch) copies of BACKEND_WINDOW perturbed with numpy seeds
# 7, 8, ..., each window held to its own optimize_window to BATCHED_TOL in
# float64, and in float32 to that float64 reading by OPTIMIZE_GATES.
# runtime: the runtime phase's first `frames` frames through ThreadedVio
# (run_runtime mode "distributed": the window sharded over runtime_shards
# shards on cuda:0, float32, blocking), its first `rerun_frames` frames run
# again for bitwise equality.
DISTRIBUTED = dict(shards=(1, 2, 4, 8), mesh2d=(2, 4), f32_shards=4, batch=(1, 4, 16), runtime_shards=4,
                   frames=12, rerun_frames=6, worker_timeout_s=300)
SHARDED_TOL = dict(pose=1e-8, cost_rtol=1e-8, hp_W=1e-7)  # tests/test_parallel.py:62-74
BATCHED_TOL = 1e-9  # tests/test_solver.py:238
# The JAX package's ThreadedVio with distributed_devices 4 on a 4-device
# virtual CPU mesh, on the same frames (scripts/jax_distributed.py float32;
# a CPU run, not a device metric)
JAX_DISTRIBUTED = dict(float32=dict(ate_m=0.023508041532269527, frames_tracked=12, landmarks=109, keyframes=6,
                                    initialized_at_frame=2))
# Gates of the runtime part: frames tracked (n - 3, the JAX end-to-end
# tests' floor), the ATE within ate_margin_m of the JAX reading, keyframes
# within one of it, landmarks within VIO_GATES' share of its count, no
# observation shed. The landmark count moves with each package's RANSAC
# draws (the port's come from its own generator) and with float32: 109
# landmarks in the JAX run, 114 in the port's float32 CPU run, 112 on the
# card; with the JAX draws replayed into the port, both sharded runtimes
# take the same decisions in float64 (tests/test_torch_parallel.py::
# test_full_vision_tracking_distributed_matches_jax: 197 and 197).
DISTRIBUTED_GATES = dict(ate_margin_m=0.003, landmarks_rel=VIO_GATES["landmarks_rel"], keyframes_margin=1)


def host_ms(fn) -> tuple:
    """(result, host ms) of one call that ends in a wait for the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, 1e3 * (time.perf_counter() - t0)


def check_sharded(dev: str) -> dict:
    """The sharded part: each mesh of DISTRIBUTED against the float64
    single-device solve; per mesh the observations shed, the errors, a
    bitwise rerun, ms and launches a call (torch.profiler)."""
    import torch

    from okvis_tpu_torch.bench import bench_scaling
    from okvis_tpu_torch.bench.bench_scaling import round_robin_slots
    from okvis_tpu_torch.parallel import make_mesh, make_mesh2d, make_sharded_optimizer, shard_problem
    from okvis_tpu_torch.solver import evaluate, optimize_window

    windows = {dt: build_window(dev, dt) for dt in (torch.float64, torch.float32)}
    cfg, imu, intr, problem, truth = windows[torch.float64]
    (ref, ref_diag), ref_ms = host_ms(lambda: optimize_window(cfg, imu, intr, problem))
    ref_cost = float(ref_diag.final_cost)
    cases = [(f"{n}", make_mesh(devices=[dev] * n), "map", torch.float64) for n in DISTRIBUTED["shards"]]
    h, m = DISTRIBUTED["mesh2d"]
    cases.append((f"{h}x{m}", make_mesh2d(h, m, devices=[dev] * (h * m)), ("host", "map"), torch.float64))
    n32 = DISTRIBUTED["f32_shards"]
    cases.append((f"{n32} float32", make_mesh(devices=[dev] * n32), "map", torch.float32))
    rows, fails = [], []
    for name, mesh, axis, dtype in cases:
        cfg, imu, intr, problem, truth = windows[dtype]
        n = mesh.size
        live = int(problem.obs.mask.sum())
        shed_in_order = live - int(shard_problem(problem, n).obs.mask.sum())
        laid, rr = round_robin_slots(problem, n)
        sharded = shard_problem(laid, n)
        opt = make_sharded_optimizer(cfg, imu, intr, mesh, axis)
        states, (cost, hist, acc, lam) = opt(sharded)
        again = opt(sharded)
        ms = 1e3 * bench_scaling.measure(n, n_iter=1, device=dev, window=windows[dtype], mesh=mesh, axis=axis)
        prof = profile_call(lambda: opt(sharded))
        hp = states.hp_W[rr]  # back to the window's slots
        row = dict(mesh=name, shards=n, axis=list(axis) if isinstance(axis, tuple) else axis,
                   dtype=str(dtype).split(".")[-1], observations=live, shed=live - int(sharded.obs.mask.sum()),
                   shed_with_slots_in_order=shed_in_order, ms_per_call=ms, launches_per_call=prof["launches"],
                   kernel_ms_per_call=prof["kernel_ms"], accepted=acc.cpu().tolist(),
                   bitwise_equal_rerun=tree_equal((states, cost, hist, acc, lam), again))
        if dtype == torch.float64:
            row.update(max_pose_err=max(float((states.r_WS - ref.r_WS).abs().max()),
                                        float((states.q_WS - ref.q_WS).abs().max())),
                       cost_rel_err=abs(float(cost) - ref_cost) / abs(ref_cost),
                       max_hp_W_err=float((hp - ref.hp_W).abs().max()))
            if not (row["max_pose_err"] <= SHARDED_TOL["pose"] and row["cost_rel_err"] <= SHARDED_TOL["cost_rtol"]
                    and row["max_hp_W_err"] <= SHARDED_TOL["hp_W"]):
                fails.append(f"mesh {name} differs from the single-device solve beyond {SHARDED_TOL}: {row}")
        else:
            S = cfg.num_states
            g = OPTIMIZE_GATES["optimize"]
            r_err, ang_err = pose_errors(states, truth["r_WS"], truth["q_WS"])
            sb_err = float((states.speed_and_bias[:S].cpu().double() - torch.as_tensor(truth["sb"])).abs().max())
            cost0 = float(evaluate(cfg, imu, intr, problem, problem.states).cost)
            row.update(position=r_err, orientation=ang_err, speed_bias=sb_err,
                       final_over_initial_cost=float(cost) / cost0)
            row["f64_position"], row["f64_orientation"] = pose_errors(states, ref.r_WS[:S].cpu().numpy(),
                                                                      ref.q_WS[:S].cpu().numpy())
            errs = (r_err, ang_err, sb_err, row["final_over_initial_cost"])
            if not (bool(torch.isfinite(states.r_WS).all()) and all(e < t for e, t in zip(errs, g["gates"]))
                    and row["f64_position"] <= g["f64"][0] and row["f64_orientation"] <= g["f64"][1]):
                fails.append(f"mesh {name} misses OPTIMIZE_GATES['optimize'] {g}: {row}")
        if row["shed"]:
            fails.append(f"mesh {name}: shard_problem shed {row['shed']} observations")
        if not row["bitwise_equal_rerun"]:
            fails.append(f"mesh {name}: the rerun differs")
        rows.append(row)
    return dict(single_device_ms=ref_ms, cases=rows, fails=fails)


def check_two_process(dev: str) -> dict:
    """The two-process part: tests/torch_multiproc_worker.py twice, ranks 0
    and 1 of a gloo group on localhost, every shard on `dev`; each killed
    when DISTRIBUTED["worker_timeout_s"] expires."""
    import os
    import socket

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_multiproc_worker.py")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, worker, str(i), "2", str(port), dev, "2"], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs, fails = [], []
    try:
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=DISTRIBUTED["worker_timeout_s"])
            except subprocess.TimeoutExpired:
                fails.append(f"worker {i} timed out")
                break
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (rc, out, err) in enumerate(outs):
        if rc != 0:
            fails.append(f"worker {i} failed (rc={rc}): {err[-2000:]}")
    ok = [line for rc, out, _ in outs[:1] for line in out.splitlines() if line.startswith("MULTIPROC_OK")]
    if not fails and not ok:
        fails.append(f"worker 0 printed no MULTIPROC_OK: {outs[0][1][-2000:] if outs else ''}")
    reading = dict(kv.split("=") for kv in ok[0].split()[1:]) if ok else {}
    return dict(mesh=[2, 2], backend="gloo", device=dev, world="tests/torch_multiproc_worker.py (L = 64, O = 256)",
                **{k: float(v) for k, v in reading.items()}, seconds=time.perf_counter() - t0, fails=fails)


def check_batched(dev: str) -> dict:
    """The batched part: at each B of DISTRIBUTED["batch"], in float64 and
    float32, optimize_windows_batched against each window's own solve; ms a
    window (one timed call, float32 also a second) and launches a call
    (torch.profiler, float32)."""
    import torch
    from torch.utils import _pytree as pytree

    from okvis_tpu_torch.datasets.synthetic import build_ba_problem
    from okvis_tpu_torch.solver import optimize_window, optimize_windows_batched

    n = max(DISTRIBUTED["batch"])
    probs = {}
    for dtype in (torch.float64, torch.float32):
        cfg, imu, intr, problem, truth = build_ba_problem(**BACKEND_WINDOW, device=dev, dtype=dtype)
        probs[dtype] = (cfg, imu, intr, [perturb_problem(problem, truth, np.random.default_rng(7 + i))
                                         for i in range(n)], truth)
    cfg, imu, intr, p64, truth = probs[torch.float64]
    singles = [optimize_window(cfg, imu, intr, p) for p in p64]
    single_ms = host_ms(lambda: optimize_window(cfg, imu, intr, p64[0]))[1]
    rows, fails = [], []
    S = cfg.num_states
    for dtype in (torch.float64, torch.float32):
        cfg, imu, intr, ps, truth = probs[dtype]
        for B in DISTRIBUTED["batch"]:
            batched = pytree.tree_map(lambda *xs: None if xs[0] is None else torch.stack(xs), *ps[:B])
            (states, diag), ms = host_ms(lambda: optimize_windows_batched(cfg, imu, intr, batched))
            row = dict(B=B, dtype=str(dtype).split(".")[-1], ms_per_call=ms, ms_per_window=ms / B)
            if dtype == torch.float32:
                ms2 = host_ms(lambda: optimize_windows_batched(cfg, imu, intr, batched))[1]
                row.update(ms_per_window_second_call=ms2 / B,
                           launches_per_call=profile_call(
                               lambda: optimize_windows_batched(cfg, imu, intr, batched))["launches"])
                errs = [pose_errors(type(states)(*(None if x is None else x[i] for x in states)),
                                    s.r_WS[:S].cpu().numpy(), s.q_WS[:S].cpu().numpy()) for i, (s, _) in
                        enumerate(singles[:B])]
                row["max_f64_position"] = max(e[0] for e in errs)
                row["max_f64_orientation"] = max(e[1] for e in errs)
                g = OPTIMIZE_GATES["optimize"]["f64"]
                if not (row["max_f64_position"] <= g[0] and row["max_f64_orientation"] <= g[1]):
                    fails.append(f"B = {B} float32 differs from the float64 solves beyond {g}: {row}")
            else:
                row["max_pose_err"] = max(float((states.r_WS[i] - s.r_WS).abs().max()) for i, (s, _) in
                                          enumerate(singles[:B]))
                row["max_cost_rel_err"] = max(abs(float(diag.final_cost[i]) - float(d.final_cost))
                                              / abs(float(d.final_cost)) for i, (_, d) in enumerate(singles[:B]))
                if not (row["max_pose_err"] <= BATCHED_TOL and row["max_cost_rel_err"] <= BATCHED_TOL):
                    fails.append(f"B = {B} float64 differs from optimize_window beyond {BATCHED_TOL}: {row}")
            if not bool(torch.isfinite(states.r_WS).all()):
                fails.append(f"B = {B} {row['dtype']}: non-finite states")
            rows.append(row)
    return dict(window="BACKEND_WINDOW", single_window_ms_float64=single_ms, cases=rows, fails=fails)


def check_distributed_runtime(dev: str) -> tuple:
    """The runtime part: the runtime phase's first DISTRIBUTED["frames"]
    frames through ThreadedVio with a sharded window, its launches by shape
    recorded, and again over its first DISTRIBUTED["rerun_frames"] frames.
    Returns its line and the kernel shapes' log of the first run."""
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    scene = vio_scene()
    shed = []
    log = logging.getLogger("okvis_tpu_torch")
    handler = logging.Handler()
    handler.emit = lambda record: shed.append(record.getMessage()) if "shedding" in record.getMessage() else None
    log.addHandler(handler)
    try:
        harris_suppressed_cuda.launches = 0
        hamming_matrix_cuda.launches = 0
        run1 = run_runtime(scene, dev, "distributed", n_frames=DISTRIBUTED["frames"],
                           snapshot_after=DISTRIBUTED["rerun_frames"])
        launches = dict(harris_nms=harris_suppressed_cuda.launches, hamming=hamming_matrix_cuda.launches)
        run2 = run_runtime(scene, dev, "distributed", n_frames=DISTRIBUTED["rerun_frames"],
                           snapshot_after=DISTRIBUTED["rerun_frames"])
    finally:
        log.removeHandler(handler)
    result = runtime_result(run1, scene.traj)
    est = run1.vio.estimator
    timed = run1.rows[2:]
    frame_ms = [r["frame_ms"] for r in timed]
    n = len(run1.rows)
    line = dict(part="runtime", frames=n, rerun_frames=len(run2.rows), keypoints=VIO_KEYPOINTS, dtype="float32",
                mesh=dict(shards=est._mesh.size, devices=[str(d) for d in est._mesh.devices]),
                window=dict(S=est.cfg.num_states, L=est.cfg.max_landmarks, O=est.cfg.max_observations),
                frame_ms=dict(median=statistics.median(frame_ms), max=max(frame_ms), timed_frames=len(frame_ms)),
                stages=run1.stages, launches=launches, launches_by_shape=shapes_of(run1.shapes),
                launches_per_frame_by_shape=shapes_of(run1.shapes, n),
                shed_warnings=shed, frames_fed=run1.frames_fed, frames_processed=run1.frames_processed,
                bitwise_equal_rerun=mode_rerun_equal(run1, run2), position_error_m=[r["position"] for r in run1.rows],
                jax_cpu_reference=JAX_DISTRIBUTED["float32"], gates=DISTRIBUTED_GATES)
    line.update({k: v for k, v in result.items() if k != "arrays"})
    ref, gates = JAX_DISTRIBUTED["float32"], DISTRIBUTED_GATES
    fails = []
    for run in (run1, run2):
        if run.frames_processed != run.frames_fed:
            fails.append(f"{run.frames_processed} of {run.frames_fed} frames processed")
    if result["frames_tracked"] < n - 3:
        fails.append(f"{result['frames_tracked']} of {n} frames tracked")
    if result["ate_m"] is None or result["ate_m"] > ref["ate_m"] + gates["ate_margin_m"]:
        fails.append(f"ATE {result['ate_m']} against the JAX float32 CPU run's {ref['ate_m']}")
    if abs(result["landmarks"] - ref["landmarks"]) > gates["landmarks_rel"] * ref["landmarks"]:
        fails.append(f"{result['landmarks']} landmarks (JAX float32 CPU run: {ref['landmarks']})")
    if abs(result["keyframes"] - ref["keyframes"]) > gates["keyframes_margin"]:
        fails.append(f"{result['keyframes']} keyframes (JAX float32 CPU run: {ref['keyframes']})")
    if shed:
        fails.append(f"observations shed: {shed}")
    if not all(line["bitwise_equal_rerun"].values()):
        fails.append(f"the rerun differs: {line['bitwise_equal_rerun']}")
    fails += [f"kernels of the path: {f}" for f in shape_count_fails(launches, run1.shapes)]
    line["fails"] = fails
    return line, run1.shapes


def check_distributed(dev: str = "cuda") -> dict:
    """The distributed phase: the sharded, two-process, batched and runtime
    parts, a `distributed` line each; each kernel held to its plain version
    at every shape the runtime part launched it at
    (`distributed_kernels`). Returns the runtime part's launches and kernel
    entries for the `kernels` line."""
    lines, fails = {}, []
    log = None
    for part, check in (("sharded", check_sharded), ("two_process", check_two_process),
                        ("batched", check_batched), ("runtime", check_distributed_runtime)):
        t0 = time.perf_counter()
        line = check(dev)
        if part == "runtime":
            line, log = line
        line["seconds"] = time.perf_counter() - t0
        print("distributed", json.dumps(dict(part=part, **{k: v for k, v in line.items() if k != "part"})))
        fails += [f"{part}: {f}" for f in line["fails"]]
        lines[part] = line
    entries = app_kernel_entries(log) if dev == "cuda" else []
    print("distributed_kernels", json.dumps(entries))
    fails += [f"{e['kernel']} at {e['shape']} differs from its plain version" for e in entries if not e["equal"]]
    if fails:
        raise SmokeError("distributed phase: " + "; ".join(fails))
    return dict(launches=lines["runtime"]["launches"], entries=entries)


# ---------------------------------------------------------------------------
# the bench phase: the port's measurement tools (okvis_tpu_torch.bench)
# ---------------------------------------------------------------------------

# pipeline: bench.py's whole run, the pipeline bench at its 35 frames (200
# keypoints, threshold 15, seeds 31 and 32, 260 landmarks at 4-8 m, 10
# warm-up frames) with its five programs replayed (wall_reps calls each,
# kernel_reps profiled), the host table of the same run and ba_bench
# (ba_iters steps); deadline_trials trials of the budget contract; the
# three capacity tiers (tier_reps calls each); profile_ba (profile_reps);
# the detect bench (detect_reps); the big window optimized once; the
# pose-graph bench (posegraph_reps solves, posegraph_query_reps queries
# of the 1,024 x 400 database); one accuracy cell through the tool's --cell
# subprocess.
BENCH = dict(pipeline_frames=35, warmup=10, wall_reps=10, kernel_reps=3, ba_iters=20, deadline_trials=20,
             tier_reps=10, profile_reps=5, detect_reps=20, posegraph_reps=3, posegraph_query_reps=3,
             posegraph_frames=1024, accuracy=("stereo", "photometric", 40, 0), cell_timeout_s=600,
             database_chunks=4)
# The JAX package's ThreadedVio in float32 on the CPU on the same worlds and
# frames (scripts/jax_bench.py pipeline 35; cell stereo photometric 40 0; a
# CPU run, not a device metric)
JAX_BENCH = dict(
    pipeline=dict(frames_fed=35, frames_tracked=35, ate_m=0.015237766848017033, landmarks=189, keyframes=9),
    accuracy=dict(frames_fed=40, frames_tracked=40, ate_m=0.005975013382836169, landmarks=106, keyframes=15))
# Gates: every pipeline frame tracked; the pipeline's and the cell's ATE
# under the accuracy proxy's bound (the pipeline world has none of its own:
# the tightest, photometric's 0.20 m) and within ate_margin_m of the JAX
# reading, frames tracked equal to JAX's; each replay bitwise equal to the
# call it captured; the five programs captured; every tier's final cost
# within tier_cost_rtol (float32: 1e-5 relative, ~100 ulps) of the full
# capacity's; the cost falls in ba_bench and in the big window.
BENCH_GATES = dict(ate_margin_m=VIO_GATES["ate_margin_m"], tier_cost_rtol=1e-5)


def bench_database_entry(log: dict, launches: int) -> dict:
    """The Hamming kernel at the pose-graph bench's database shape (400,
    409,600) on the last arguments the query launched it with: against its
    plain version exactly, the plain version run over
    BENCH["database_chunks"] column blocks (at full width its XOR
    temporaries alone are ~10 GB), timed beside it and beside the ±1
    float32 torch.matmul, with its bound."""
    import torch

    from okvis_tpu_torch.ops.hamming import masked_distance_matrix_plain
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    [(_, ((a, b, ma, mb), _))] = [v for k, v in log.items() if k[0] == "hamming"]
    n = BENCH["database_chunks"]

    def plain():
        return torch.cat([masked_distance_matrix_plain(a, bc, ma, mc) for bc, mc in
                          zip(b.chunk(n), mb.chunk(n))], dim=1)

    dk, dp = hamming_matrix_cuda(a, b, ma, mb), plain()
    torch.cuda.synchronize()
    na, nb = dk.shape
    n_bytes = (a.numel() + b.numel()) * 4 + mb.numel() + na * nb * 4
    bound_ms, bound_by = bound(n_bytes, *({c: k * na * nb for c, k in r.items()} for r in HAMMING_ROUTES))
    return dict(shape=[na, nb], launches=launches, max_abs_err=int((dk - dp).abs().max()),
                equal=bool(torch.equal(dk, dp)), ms=device_ms(lambda: hamming_matrix_cuda(a, b, ma, mb)),
                plain_ms=device_ms(plain, reps=3, inner=1), plain=f"in {n} column blocks",
                library_ms=device_ms(pm1_product(a, b, dk.shape)), library="±1 float32 torch.matmul",
                bound_ms=bound_ms, bound_by=bound_by)


def check_bench(dev: str = "cuda") -> dict:
    """The bench phase: each tool of okvis_tpu_torch.bench at BENCH's sizes,
    held to BENCH_GATES and JAX_BENCH; the kernels of the pipeline run held
    to their plain versions at every shape it launched them at, the
    database query's Hamming launch at (400, 409,600). Prints one `bench`
    line with every reading; returns the launches and kernel entries for the
    `kernels` line."""
    from okvis_tpu_torch.bench import (accuracy_proxy, bench, bench_big_window, bench_deadline, bench_detect,
                                       bench_posegraph, bench_tiers, profile_ba)
    from okvis_tpu_torch.bench.bench_host import host_table
    from okvis_tpu_torch.bench.bench_pipeline import PROGRAMS, run_pipeline_bench

    line, fails, seconds = {}, [], {}

    def timed(part, fn):
        t0 = time.perf_counter()
        res = fn()
        seconds[part] = time.perf_counter() - t0
        return res

    # bench.py's run: the pipeline bench, the host table of that run, ba_bench
    pipe_log, counts0 = {}, kernel_counts()
    with kernel_shapes(pipe_log):
        pipe = timed("pipeline", lambda: run_pipeline_bench(
            BENCH["pipeline_frames"], device=dev, warmup=BENCH["warmup"], wall_reps=BENCH["wall_reps"],
            kernel_reps=BENCH["kernel_reps"], verbose=False))
    launches = {k: v - counts0[k] for k, v in kernel_counts().items()}
    ba = timed("ba_bench", lambda: bench.ba_bench(dev, BENCH["ba_iters"], verbose=False))
    line["pipeline"] = dict(pipe, launches=launches, launches_by_shape=shapes_of(pipe_log),
                            jax_cpu_reference=JAX_BENCH["pipeline"])
    line["host"] = host_table(pipe)
    line["ba_bench"] = ba
    line["headline"] = dict(metric="pipeline_frames_per_s", value=pipe["value"], unit="frames/s",
                            vs_baseline=pipe["value"] / bench.BASELINE_FPS,
                            device_fps_ceiling=pipe["device_fps_ceiling"],
                            device_fps_ceiling_rt=pipe["device_fps_ceiling_rt"],
                            ba_optimize_steps_per_s=ba["steps_per_s"])
    ref, bound_m = JAX_BENCH["pipeline"], min(accuracy_proxy.BOUNDS_M.values())
    if pipe["frames"] != pipe["frames_fed"] or pipe["frames"] != ref["frames_tracked"]:
        fails.append(f"pipeline: {pipe['frames']} of {pipe['frames_fed']} frames tracked (JAX: "
                     f"{ref['frames_tracked']})")
    if pipe["ate_m"] is None or not (pipe["ate_m"] < bound_m and abs(pipe["ate_m"] - ref["ate_m"])
                                     <= BENCH_GATES["ate_margin_m"]):
        fails.append(f"pipeline: ATE {pipe['ate_m']} (bound {bound_m}, JAX float32 CPU {ref['ate_m']})")
    if sorted(pipe["programs"]) != sorted(PROGRAMS):
        fails.append(f"pipeline: captured {pipe['programs_captured']}, not {PROGRAMS}")
    fails += [f"pipeline: the {tag} replay differs from its captured call" for tag, r in pipe["programs"].items()
              if r["bitwise_equal"] is not True]
    fails += [f"pipeline: {f}" for f in shape_count_fails(launches, pipe_log)]
    if not ba["final_cost"] < ba["initial_cost"]:
        fails.append(f"ba_bench: the cost did not fall ({ba['initial_cost']} -> {ba['final_cost']})")
    # the layer benches
    line["deadline"] = timed("deadline", lambda: bench_deadline.run(BENCH["deadline_trials"], device=dev,
                                                                    verbose=False))
    line["tiers"] = tiers = timed("tiers", lambda: bench_tiers.run(BENCH["tier_reps"], dev, verbose=False))
    if not tiers["max_cost_rel_diff"] <= BENCH_GATES["tier_cost_rtol"]:
        fails.append(f"tiers: final costs {[t['final_cost'] for t in tiers['tiers']]} differ by "
                     f"{tiers['max_cost_rel_diff']} relative")
    line["profile_ba"] = timed("profile_ba", lambda: profile_ba.run(BENCH["profile_reps"], dev, verbose=False))
    line["detect"] = det = timed("detect", lambda: bench_detect.run(BENCH["detect_reps"], dev, verbose=False))
    if not det["route_equals_plain"]:
        fails.append("detect: the Harris kernel differs from its plain version")
    line["big_window"] = big = timed("big_window", lambda: bench_big_window.run(("big",), 1, dev, verbose=False))
    if not big["windows"]["big"]["final_cost"] < big["windows"]["big"]["initial_cost"]:
        fails.append(f"big window: the cost did not fall: {big['windows']['big']}")
    db_log, h0 = {}, kernel_counts()["hamming"]
    with kernel_shapes(db_log):
        pg = timed("posegraph", lambda: bench_posegraph.run(
            reps=BENCH["posegraph_reps"], frames=BENCH["posegraph_frames"], query_reps=BENCH["posegraph_query_reps"],
            device=dev, verbose=False))
    db_launches = kernel_counts()["hamming"] - h0
    line["posegraph"] = dict(pg, hamming_launches=db_launches, launches_by_shape=shapes_of(db_log))
    key = f"400x{BENCH['posegraph_frames'] * 400}"
    if set(db_log) != {("hamming", key)} or db_launches != 1 + BENCH["posegraph_query_reps"]:
        fails.append(f"posegraph: Hamming launches {db_launches}, by shape {shapes_of(db_log)}")
    # one accuracy cell, through the tool's --cell subprocess
    config, scen, n, seed = BENCH["accuracy"]
    rec, rc, err = timed("accuracy", lambda: accuracy_proxy.run_cell(config, scen, seed, n, dev,
                                                                     timeout=BENCH["cell_timeout_s"]))
    aref = JAX_BENCH["accuracy"]
    line["accuracy"] = dict(cell=dict(config=config, scenario=scen, frames=n, seed=seed), record=rec, rc=rc,
                            jax_cpu_reference=aref)
    if rec is None:
        fails.append(f"accuracy cell failed (rc={rc}): {err}")
    else:
        med, bnd, ok = accuracy_proxy._gate(config, scen, [rec])
        line["accuracy"].update(median_ate_m=med, bound_m=bnd, ok=ok)
        if not ok or rec["frames"] != aref["frames_tracked"] or abs(rec["ate_m"] - aref["ate_m"]) > \
                BENCH_GATES["ate_margin_m"]:
            fails.append(f"accuracy {config}/{scen}: {rec['frames']} of {rec['fed']} frames, ATE {rec['ate_m']} "
                         f"(bound {bnd}, JAX float32 CPU {aref})")
    # each kernel against its plain version: the pipeline's shapes, the database
    entries = app_kernel_entries(pipe_log) if dev == "cuda" else []
    fails += [f"{e['kernel']} at {e['shape']} differs from its plain version" for e in entries if not e["equal"]]
    database = bench_database_entry(db_log, db_launches) if dev == "cuda" else None
    if database is not None and (database["max_abs_err"] or not database["equal"]):
        fails.append(f"the Hamming kernel differs from its plain version at {database['shape']}")
    line.update(kernels=entries, database=database, seconds=seconds, gates=BENCH_GATES, fails=fails)
    print("bench", json.dumps(line))
    if fails:
        raise SmokeError("bench phase: " + "; ".join(fails))
    return dict(launches=dict(bench=launches, bench_posegraph=dict(harris_nms=0, hamming=db_launches)),
                entries=entries, database=database)


def kernel_resources(build_log: str, lib) -> dict:
    """Registers, spills and static shared memory of every kernel ptxas
    compiled, from the build log (-Xptxas -v), keyed by the kernel's name and
    its integer template arguments, and the Harris kernel's dynamic shared
    memory a block, from the library."""
    out = {}
    for part in build_log.split("Compiling entry function '")[1:]:
        mangled = part.split("'", 1)[0]
        found = re.search(r"\d+([a-z_]+_kernel)", mangled)
        name = found.group(1) if found else mangled
        args = re.findall(r"L[ib](\d+)E", mangled)  # int and bool template arguments
        key = name + (f"<{','.join(args)}>" if args else "")
        num = lambda pat: int(m.group(1)) if (m := re.search(pat, part)) else 0  # noqa: E731
        out[key] = dict(registers=num(r"Used (\d+) registers"), spill_stores=num(r"(\d+) bytes spill stores"),
                        spill_loads=num(r"(\d+) bytes spill loads"), static_smem=num(r"(\d+) bytes smem"))
        if name == "harris_nms_kernel":  # template arguments: the blur and NMS radii
            out[key]["dynamic_smem"] = lib.okvis_harris_nms_shared_bytes(int(args[0]), int(args[1]))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing measured", file=sys.stderr)
        return 2
    from okvis_tpu_torch.ops import cuda_lib
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    print("torch", torch.__version__, "cuda", torch.version.cuda, "python", sys.version.split()[0])
    t0 = time.perf_counter()
    lib = cuda_lib.load_library()
    print(f"build_seconds {time.perf_counter() - t0:.2f}")
    print(cuda_lib.build_log, file=sys.stderr)
    print("kernel_resources", json.dumps(kernel_resources(cuda_lib.build_log, lib)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    t_start = time.perf_counter()
    frontend = build_frontend("cuda")
    traj, lms, idx = scenario(N_FRAMES)
    frames = render_frames(frontend, traj, lms, idx)
    sync = torch.cuda.synchronize
    run_slice(frontend, frames[:1], lms, sync)  # warm-up: caches, cuBLAS, allocator

    harris_suppressed_cuda.launches = 0
    hamming_matrix_cuda.launches = 0
    stats, fds = run_slice(frontend, frames, lms, sync)
    launches = dict(harris_nms=harris_suppressed_cuda.launches, hamming=hamming_matrix_cuda.launches)
    print("launches", json.dumps(launches))
    if min(launches.values()) == 0:
        raise SmokeError(f"a kernel of the main path was never launched: {launches}")
    check_ground_truth(stats)
    stages = dict(frames=len(stats))
    for key in ("detect_ms", "stereo_ms"):
        vals = [s[key] for s in stats]
        stages[key] = dict(median=statistics.median(vals), max=max(vals))
    print("per_frame", json.dumps(stages))
    profile_slice(frontend, frames[:5], lms)

    images = torch.stack([torch.as_tensor(im, device="cuda") for im in frames[-1][1]]).float()
    chk = check_kernels(images.contiguous(), fds)
    check_against_cpu(frames, fds)
    kernels = time_kernels(images.contiguous(), chk, launches)

    @contextlib.contextmanager
    def sync_free():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")

    print(f"vision_seconds {time.perf_counter() - t_start:.2f}")
    t0 = time.perf_counter()
    stages, eqs, cfg = check_backend("cuda", sync_free)
    time_backend(stages, eqs, cfg)
    print(f"backend_seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    est_launches = check_estimator()
    print(f"estimator_seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    vio = check_vio()
    print(f"vio_seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    runtime = check_runtime(vio)
    print(f"runtime_seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    modes = check_modes()
    print(f"modes_seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    posegraph = check_posegraph()
    print(f"posegraph_seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    app = check_app()
    print(f"app_seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    distributed = check_distributed()
    print(f"distributed_seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    bench = check_bench()
    print(f"bench_seconds {time.perf_counter() - t0:.2f}")
    # `launches` is the runtime's (the main path, through ThreadedVio); the
    # other paths' counts stay beside it
    for k, name in zip(kernels, ("harris_nms", "hamming")):
        k["launches_by_path"] = dict(vision=k["launches"], estimator=est_launches[name], vio=vio["launches"][name],
                                     runtime=runtime["launches"][name],
                                     **{m: modes["launches"][m][name] for m in MODES},
                                     **{p: n[name] for p, n in posegraph["launches"].items()},
                                     **{p: n[name] for p, n in app["launches"].items()},
                                     distributed=distributed["launches"][name],
                                     **{p: n[name] for p, n in bench["launches"].items()})
        k["launches"] = runtime["launches"][name]
        # each app part's and the sharded runtime's launches at each shape,
        # each held to the plain version
        for part, entries in dict(app["entries"], distributed_by_shape=distributed["entries"],
                                  bench_by_shape=bench["entries"]).items():
            k[part] = [{key: e[key] for key in ("shape", "launches", "equal", "max_abs_err", "ms", "plain_ms",
                                                "bound_ms", "bound_by", "library_ms")}
                       for e in entries if e["kernel"] == name]
    kernels[0]["octave_shapes"] = modes["kernels"]["harris_octaves"]
    kernels[1]["association"] = vio["association"]
    kernels[1]["mono_association"] = modes["kernels"]["hamming_mono_association"]
    kernels[1]["database"] = posegraph["database"]
    kernels[1]["bench_database"] = bench["database"]
    print(f"smoke_seconds {time.perf_counter() - t_start:.2f}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
