#!/usr/bin/env python3
"""Drive the okvis_tpu_torch stereo slice on one CUDA card and check it.

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
   the floor of a launch, and the per-frame stages with the host clock.

Prints the `kernels` JSON line, and as its last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero without the
ok line; so does a run without CUDA or without the okvis_tpu_torch package.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# ground-truth floors, set from a CPU run of the same frames (PERF.md)
MIN_KEYPOINTS = 30  # valid keypoints per camera and frame (CPU run: >= 43)
MIN_MATCHES = 12  # stereo matches per frame (CPU run: >= 23)
MIN_DEPTH_SHARE = 0.85  # valid triangulations within 10 % depth (CPU run: 0.955)

N_FRAMES = 20  # frames of the smoke sequence

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
