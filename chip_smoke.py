#!/usr/bin/env python3
"""Drive the okvis_tpu_torch vision slice, back end, estimator and the
per-frame VIO loop on one CUDA card and check them.

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
   path's shapes: Harris raw bit for bit from 10 px inside the image and
   the same suppressed pattern; Hamming exactly, masked and unmasked, at the
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
   bitwise equality; prints the `vio` line.

Prints the `kernels` JSON line (each kernel's `launches` from the vio loop,
the other paths' in `launches_by_path`), and as its last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero without the
ok line; so does a run without CUDA or without the okvis_tpu_torch package.
"""

from __future__ import annotations

import contextlib
import json
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
    # the two agree bit for bit from 10 px inside the image (csrc/harris_nms.cu)
    inner = (slice(None), slice(10, H - 10), slice(10, W - 10))
    a, b = raw_k[inner], raw_p[inner]
    harris_err = float((a - b).abs().max())
    if not torch.equal(a, b):
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
    states64 = type(states)(*(x.cpu().double() for x in states))
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


def profile_call(fn, top: int = 0) -> dict:
    """One call under torch.profiler: its device kernels' summed time, their
    launches, and the `top` kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    out = dict(kernel_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
               launches=sum(e.count for e in kernels))
    if top:
        out["top"] = [dict(kernel=e.key[:80], device_ms=e.self_device_time_total / 1e3, calls=e.count)
                      for e in kernels[:top]]
    return out


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

    from okvis_tpu_torch.solver.optimize import _spd_solve_newton

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
    # the dense solve alone, on the window's own Jacobi-scaled system
    s = torch.sqrt(torch.clamp(torch.diagonal(eqs.H_dd), min=1e-12))
    Hs = eqs.H_dd / (s[:, None] * s[None, :]) + 1e-10 * torch.eye(cfg.dense_dim, device=s.device)
    newton = profile_call(lambda: _spd_solve_newton(Hs, eqs.b_d / s))
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
        optimize={name: torch.equal(a, b) for name, a, b in zip(states._fields, states, states0)},
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
            kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
            kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            summary = dict(frames=b - a, wall_ms=wall_ms, kernel_ms=kernel_ms, device_busy_share=kernel_ms / wall_ms,
                           launches_per_frame=sum(e.count for e in kernels) / (b - a))
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

    frames, init = estimator_frames()
    harris_suppressed_cuda.launches = 0
    hamming_matrix_cuda.launches = 0
    runs = {}
    # The float64 CPU references run in two worker processes while the card
    # repeats LM + Newton-Schulz (a run whose times are not reported); the
    # timed card runs have the host to themselves.
    runs["optimize"] = run_estimator("optimize", "cuda", torch.float32, frames, init, profile=True)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing.get_context("spawn")) as pool:
        refs = {v: pool.submit(estimator_reference, v) for v in ESTIMATOR_GATES}
        rerun = estimator_window(run_estimator("optimize", "cuda", torch.float32, frames, init)[0])
        refs = {v: f.result() for v, f in refs.items()}
    print(f"estimator_reference_seconds {time.perf_counter() - t0:.2f}")
    runs["optimize_cholesky"] = run_estimator("optimize_cholesky", "cuda", torch.float32, frames, init, profile=True)
    for variant, gates in ESTIMATOR_GATES.items():
        est, rows, summary = runs[variant]
        print("estimator_frames", json.dumps(dict(variant=variant, frames=[
            {k: r[k] for k in ("frame", "tier", "frames", "links", "position", "orientation")} for r in rows])))
        line = estimator_line(variant, rows, summary)
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


def vio_scene():
    """The vio phase's world (datasets.synthetic.vio_scenario: the scenario
    of tests/test_vision_e2e.py::test_full_vision_tracking), rendered on the
    CPU."""
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, vio_scenario

    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    return vio_scenario(NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr), VIO_FRAMES)


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
                kern = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
                kernel_ms = sum(e.self_device_time_total for e in kern) / 1e3
                summary = dict(frames=b - a, wall_ms=wall_ms, kernel_ms=kernel_ms,
                               device_busy_share=kernel_ms / wall_ms,
                               launches_per_frame=sum(e.count for e in kern) / (b - a))
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
    return dict(launches=launches, association=assoc)


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
    # `launches` is the vio loop's (this slice's main path); the vision
    # slice's count stays beside it
    for k, name in zip(kernels, ("harris_nms", "hamming")):
        k["launches_by_path"] = dict(vision=k["launches"], estimator=est_launches[name], vio=vio["launches"][name])
        k["launches"] = vio["launches"][name]
    kernels[1]["association"] = vio["association"]
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
