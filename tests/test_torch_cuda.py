"""The hand-written CUDA kernels against their plain torch versions, on the
card. Marked `cuda`; every test skips where torch sees no CUDA device (the
CPU parity tests hold the plain versions to the JAX package). Run on a
machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from okvis_tpu_torch.frontend import detection
from okvis_tpu_torch.ops.hamming import (
    MAX_DIST, hamming_matrix_mxu, hamming_matrix_plain, masked_distance_matrix,
    masked_distance_matrix_plain, mutual_best_assignment)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("na,nb", [(400, 400), (400, 3200), (400, 102400), (1, 1), (17, 33), (0, 5)])
def test_hamming_kernel_equals_plain(cuda, na, nb):
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    rng = np.random.default_rng(na + nb)
    a = torch.from_numpy(rng.integers(0, 2**32, (na, 16), dtype=np.uint32).view(np.int32)).to(cuda)
    b = torch.from_numpy(rng.integers(0, 2**32, (nb, 16), dtype=np.uint32).view(np.int32)).to(cuda)
    before = hamming_matrix_cuda.launches
    got = hamming_matrix_cuda(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, hamming_matrix_plain(a, b))
    if na and nb:
        assert torch.equal(got, hamming_matrix_mxu(a, b))
        assert hamming_matrix_cuda.launches == before + 1


def _random_case(cuda, seed, g, na, nb, gb, masked):
    """(G, NA, 16) A, (GB, NB, 16) B with bit 31 set somewhere, and random
    bool masks of the same batches (None where unmasked)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (g, na, 16), dtype=np.uint32)
    b = rng.integers(0, 2**32, (gb, nb, 16), dtype=np.uint32)
    if na:
        a[:, 0, 0] = 0x80000001
    t = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    ma = t(rng.uniform(size=(g, na)) > 0.1) if masked else None
    mb = t(rng.uniform(size=(gb, nb)) > 0.1) if masked else None
    return t(a.view(np.int32)), t(b.view(np.int32)), ma, mb


# (G, NA, NB, batch of B, masked): the stereo pair, the association batch
# (P = 4 sources x C = 2 cameras, one frame's B broadcast), database shapes
# (the runtime's keyframe database: 256 keyframes x 400 keypoints),
# ragged shapes that divide the 32 x 64 block tile in neither direction, and
# empty ones
@pytest.mark.parametrize("g,na,nb,gb,masked", [
    (1, 400, 400, 1, True), (8, 400, 400, 1, True), (8, 400, 400, 8, False),
    (1, 400, 3200, 1, False), (1, 400, 3200, 1, True), (1, 400, 102400, 1, True), (3, 397, 1001, 3, True),
    (2, 1, 1, 1, True), (1, 17, 33, 1, True), (2, 0, 5, 1, True), (2, 5, 0, 2, True)])
def test_masked_hamming_kernel_equals_plain(cuda, g, na, nb, gb, masked):
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    a, b, ma, mb = _random_case(cuda, g * 1000 + na + nb, g, na, nb, gb, masked)
    before = hamming_matrix_cuda.launches
    got = hamming_matrix_cuda(a, b, ma, mb)
    torch.cuda.synchronize()
    assert got.shape == (g, na, nb) and got.dtype == torch.int32
    assert torch.equal(got, masked_distance_matrix_plain(a, b, ma, mb))
    assert hamming_matrix_cuda.launches == before + (1 if na and nb else 0)


def test_masked_distance_matrix_is_one_kernel(cuda):
    """The stereo call (2-D, masked) and the association call (batch 8, B
    broadcast): one launch each, and the profiler sees one kernel and no
    other device work; all-false masks give MAX_DIST everywhere."""
    from torch.profiler import ProfilerActivity, profile

    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    a, b, ma, mb = _random_case(cuda, 9, 8, 400, 400, 1, True)
    stereo = (a[0], b[0], ma[0], mb[0])
    for args in (stereo, (a, b, ma, mb)):
        masked_distance_matrix(*args)  # built and warm
        torch.cuda.synchronize()
        before = hamming_matrix_cuda.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = masked_distance_matrix(*args)
            torch.cuda.synchronize()
        assert hamming_matrix_cuda.launches == before + 1
        kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
        assert len(kernels) == 1 and "hamming" in kernels[0].name, [e.name for e in kernels]
        assert torch.equal(got, masked_distance_matrix_plain(*args))
    assert stereo[0].dim() == 2 and got.dim() == 3
    none = torch.zeros_like(ma)
    assert (masked_distance_matrix(a, b, none, mb) == MAX_DIST).all()


def test_hamming_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    a, b, ma, mb = _random_case(cuda, 10, 2, 40, 30, 1, True)
    before = hamming_matrix_cuda.launches
    with pytest.raises(ValueError, match="torch.bool"):
        hamming_matrix_cuda(a, b, ma.to(torch.uint8), mb)
    with pytest.raises(ValueError, match="mask must be a contiguous"):
        hamming_matrix_cuda(a, b, ma[:, :-1], mb)
    with pytest.raises(ValueError, match="do not broadcast"):
        hamming_matrix_cuda(a, b, ma, mb.expand(3, -1).contiguous())
    with pytest.raises(ValueError, match="int32"):
        hamming_matrix_cuda(a.to(torch.int64), b)
    with pytest.raises(ValueError, match="contiguous"):
        hamming_matrix_cuda(a.transpose(0, 1), b)
    # 2^16 x 2^15 outputs: the kernel's 32-bit offsets would overflow
    big_a = torch.zeros((1 << 16, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="32-bit offsets"):
        hamming_matrix_cuda(big_a, big_a[: 1 << 15])
    assert hamming_matrix_cuda.launches == before


def _harris_both(img, inb, nms_radius):
    """Kernel and plain version on the same card tensors; the kernel is
    launched exactly once."""
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda

    before = harris_suppressed_cuda.launches
    raw_k, sup_k = harris_suppressed_cuda(img, inb, nms_radius=nms_radius)
    raw_p, sup_p = detection.harris_suppressed_plain(img, inb, nms_radius=nms_radius)
    torch.cuda.synchronize()
    assert harris_suppressed_cuda.launches == before + 1
    return raw_k, sup_k, raw_p, sup_p


# (2, 480, 752) is the main path's shape; (1, 37, 41) and (2, 481, 753) divide
# the kernel's 64 x 44 tile in neither direction
@pytest.mark.parametrize("C,H,W,nms_radius,border",
                         [(2, 480, 752, 4, 20), (1, 96, 128, 4, 20), (3, 61, 83, 4, 20), (2, 240, 376, 2, 20),
                          (1, 37, 41, 4, 10), (2, 481, 753, 4, 20), (1, 37, 41, 2, 10)])
def test_harris_kernel_matches_plain(cuda, C, H, W, nms_radius, border):
    rng = np.random.default_rng(C * H + W)
    img = torch.from_numpy(rng.uniform(0, 255, (C, H, W)).astype(np.float32)).to(cuda)
    inb = detection.border_mask(H, W, border, cuda).expand(C, H, W).float().contiguous()
    raw_k, sup_k, raw_p, sup_p = _harris_both(img, inb, nms_radius)
    # bit for bit over the whole image: the kernel reads the image edge as the
    # plain version does (wrapped Scharr, edge-padded blur)
    assert torch.equal(raw_k, raw_p)
    assert torch.equal(torch.isfinite(sup_k), torch.isfinite(sup_p))
    assert torch.equal(sup_k[torch.isfinite(sup_p)], sup_p[torch.isfinite(sup_p)])


# the pyramid's octaves of a 2 x 480 x 752 multiframe, with a detection mask
# that blanks the left 64 columns and the bottom 48 rows (subsampled per
# octave as detect_keypoints_pyramid does) and the per-octave border
# max(4, 20 // 2^o): the selection region comes to 5 px of the edge at the
# last octave
@pytest.mark.parametrize("octave", [0, 1, 2])
def test_harris_kernel_matches_plain_at_the_pyramid_octaves(cuda, octave):
    rng = np.random.default_rng(40 + octave)
    H, W = 480 >> octave, 752 >> octave
    img = torch.from_numpy(rng.uniform(0, 255, (2, H, W)).astype(np.float32)).to(cuda)
    mask = torch.ones(2, 480, 752, dtype=torch.bool, device=cuda)
    mask[:, :, :64] = False
    mask[:, -48:] = False
    mask = mask[:, :: 1 << octave, :: 1 << octave]
    inb = (detection.border_mask(H, W, max(4, 20 >> octave), cuda) & mask).float().contiguous()
    raw_k, sup_k, raw_p, sup_p = _harris_both(img, inb, 4)
    assert torch.equal(raw_k, raw_p)
    assert torch.equal(torch.isfinite(sup_k), torch.isfinite(sup_p))
    assert torch.equal(sup_k[torch.isfinite(sup_p)], sup_p[torch.isfinite(sup_p)])
    assert int(torch.isfinite(sup_p).sum()) > 100


def test_pyramid_detection_kernel_path_matches_plain_path(cuda):
    """detect_keypoints_pyramid on the card (one Harris launch an octave)
    against the same function on the CPU (the plain version), masked."""
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda

    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (2, 480, 752)).astype(np.float32)
    mask = np.ones((2, 480, 752), bool)
    mask[:, :, :64] = False
    mask[:, -48:] = False
    before = harris_suppressed_cuda.launches
    kk, sk = detection.detect_keypoints_pyramid(torch.from_numpy(img).to(cuda), threshold=40.0,
                                                max_keypoints=400, octaves=2, mask=torch.from_numpy(mask).to(cuda))
    assert harris_suppressed_cuda.launches == before + 3
    kp, sp = detection.detect_keypoints_pyramid(torch.from_numpy(img), threshold=40.0, max_keypoints=400,
                                                octaves=2, mask=torch.from_numpy(mask))
    assert torch.equal(kk.mask.cpu(), kp.mask) and torch.equal(sk.cpu(), sp)
    torch.testing.assert_close(kk.uv.cpu()[kp.mask], kp.uv[kp.mask], rtol=0, atol=1e-3)


def test_harris_kernel_keeps_plateau_maxima(cuda):
    """Constant 16 x 16 blocks: inside a block the response is exactly 0 over
    whole windows, and every pixel of such a plateau is its window's max."""
    rng = np.random.default_rng(6)
    levels = rng.integers(0, 4, (2, 10, 16)).astype(np.float32) * 60.0
    img = torch.from_numpy(np.kron(levels, np.ones((16, 16), np.float32))).to(cuda).contiguous()
    C, H, W = img.shape
    inb = detection.border_mask(H, W, 20, cuda).expand(C, H, W).float().contiguous()
    raw_k, sup_k, raw_p, sup_p = _harris_both(img, inb, 4)
    assert torch.equal(raw_k, raw_p)
    assert torch.equal(torch.isfinite(sup_k), torch.isfinite(sup_p))
    flat = torch.isfinite(sup_p) & (raw_p == 0)
    assert int(flat.sum()) > 100  # plateau survivors exist, and the kernel kept them all


def test_detect_keypoints_kernel_path_matches_plain_path(cuda):
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 240, 376)).astype(np.float32)).to(cuda)
    kk = detection.detect_keypoints(img, threshold=1.0, max_keypoints=128)
    inb = detection.border_mask(240, 376, 20, cuda).expand(2, 240, 376).float().contiguous()
    kp = detection.select_keypoints(*detection.harris_suppressed_plain(img, inb), 1.0, 128, 4)
    assert torch.equal(kk.mask, kp.mask)
    torch.testing.assert_close(kk.uv[kk.mask], kp.uv[kp.mask], rtol=0, atol=1e-3)


def test_harris_kernel_rejects_radii_it_was_not_built_for(cuda):
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda

    img = torch.zeros(1, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="nms radius"):
        harris_suppressed_cuda(img, torch.ones_like(img), nms_radius=3)


def test_assignment_on_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(4)
    d = torch.from_numpy(rng.integers(0, 6, (300, 280)).astype(np.int32))
    for ratio in (0.0, 0.8):
        want = mutual_best_assignment(d, 4, distance_ratio=ratio)
        got = mutual_best_assignment(d.to(cuda), 4, distance_ratio=ratio).cpu()
        assert torch.equal(got, want)


# ---------------------------------------------------------------- back end
# float32 on the card against float64 on the CPU; the tolerances are those
# chip_smoke.py states for the full window (PERF.md)


@pytest.fixture(scope="module")
def small_window():
    """build_ba_problem(num_frames=4, n_landmarks=96) on the card in float32
    and on the CPU in float64, both perturbed with seed 7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from okvis_tpu_torch.datasets.synthetic import build_ba_problem

    from chip_smoke import perturb_problem

    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        cfg, imu, intr, problem, truth = build_ba_problem(num_frames=4, n_landmarks=96, device=dev, dtype=dtype)
        out[dev] = (cfg, imu, intr, perturb_problem(problem, truth, np.random.default_rng(7)), truth)
    return out


@pytest.mark.parametrize("solver", ["newton", "cholesky"])
def test_optimize_window_on_the_card_has_no_host_sync(small_window, solver):
    """Both dense solvers run with no host sync. In float32 the
    Newton-Schulz solve is not backward stable once the LM damping is small
    (its runs spread by centimetres, in the JAX package too; PERF.md), so it
    is held to a lower cost; Cholesky to the reference gates and float64."""
    from okvis_tpu_torch.solver import evaluate, optimize_window

    cfg, imu, intr, problem, truth = small_window["cuda"]
    cfg = dataclasses.replace(cfg, dense_solver=solver)
    optimize_window(cfg, imu, intr, problem)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, diag = optimize_window(cfg, imu, intr, problem)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    S = truth["r_WS"].shape[0]
    cost0 = float(evaluate(cfg, imu, intr, problem, problem.states).cost)
    assert bool(torch.isfinite(states.r_WS).all()) and float(diag.final_cost) < 0.1 * cost0
    if solver == "cholesky":
        assert float((states.r_WS[:S].cpu().double() - torch.from_numpy(truth["r_WS"])).abs().max()) < 0.1
        cfg64, imu64, intr64, problem64, _ = small_window["cpu"]
        states64, _ = optimize_window(dataclasses.replace(cfg64, dense_solver=solver), imu64, intr64, problem64)
        assert float((states.r_WS[:S].cpu().double() - states64.r_WS[:S]).abs().max()) < 0.01


def test_preintegrate_batched_on_the_card_matches_cpu(small_window):
    """The window's links in one call on the card, with no host sync, against
    the float64 CPU build of the same links."""
    from okvis_tpu_torch.imu import preintegrate

    cfg, imu, _, problem, truth = small_window["cuda"]
    links = truth["imu_links"]
    args = [torch.as_tensor(v).to("cuda", torch.float32) for v in links.values()]
    preintegrate(imu, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pre = preintegrate(imu, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pre64 = small_window["cpu"][3].imu_links.pre
    K = args[0].shape[0]
    for name in pre._fields:
        got, want = getattr(pre, name).cpu().double(), getattr(pre64, name)[:K]
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


def test_marginalize_system_on_the_card_is_psd_and_matches_cpu():
    """A least-squares system with the VIO sparsity (tests/test_marginalization.py's
    construction) marginalized on the card in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from okvis_tpu_torch.estimator.marginalization import marginalize_system
    from okvis_tpu_torch.solver import WindowConfig
    from okvis_tpu_torch.solver.assemble import NormalEqs

    cfg = WindowConfig(num_states=2, num_cameras=1, max_landmarks=4, max_observations=8, max_imu_links=1)
    D, L = cfg.dense_dim, cfg.max_landmarks
    rng = np.random.default_rng(42)
    rows = []
    for lm in range(L):
        for _ in range(12):
            row = np.zeros(D + 3 * L)
            row[:D] = rng.normal(size=D) * 0.3
            row[D + 3 * lm: D + 3 * lm + 3] = rng.normal(size=3)
            rows.append(row)
    rows += [np.concatenate([rng.normal(size=D), np.zeros(3 * L)]) for _ in range(D + 5)]
    J = np.stack(rows)
    H, b = J.T @ J, J.T @ rng.normal(size=len(rows))
    eqs = NormalEqs(
        H_dd=H[:D, :D], b_d=b[:D],
        H_ll=np.stack([H[D + 3 * i: D + 3 * i + 3, D + 3 * i: D + 3 * i + 3] for i in range(L)]),
        b_l=b[D:].reshape(L, 3), W=np.stack([H[:D, D + 3 * i: D + 3 * i + 3] for i in range(L)]),
        cost=np.asarray(0.0))
    marg = torch.arange(D) < 15
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        e = NormalEqs(*(torch.as_tensor(x).to(dev, dtype) for x in eqs))
        m = marg.to(dev)
        out[dev] = marginalize_system(cfg, e, m, ~m, torch.ones(L, dtype=torch.bool, device=dev),
                                      torch.ones((), dtype=dtype, device=dev))
    Hc = out["cuda"].H.cpu().double()
    w = torch.linalg.eigvalsh(Hc)
    assert float(w.min()) >= -1e-6 * float(w.max())
    assert float((Hc - Hc.T).abs().max()) <= 1e-6 * float(Hc.abs().max())
    assert float(Hc[:15].abs().max()) == 0.0 and float(out["cuda"].b0[:15].abs().max()) == 0.0
    H64 = out["cpu"].H
    assert float((Hc - H64).abs().max()) <= 1e-3 * float(H64.abs().max())


def test_evaluate_and_optimize_on_the_card_are_bitwise_repeatable(small_window):
    """The assembly sums in a fixed order: two evaluates, and two LM +
    Newton-Schulz optimizes, of the same inputs give the same bits."""
    from okvis_tpu_torch.solver import evaluate, optimize_window

    cfg, imu, intr, problem, _ = small_window["cuda"]
    e1, e2 = (evaluate(cfg, imu, intr, problem, problem.states) for _ in range(2))
    for name, a, b in zip(e1._fields, e1, e2):
        assert torch.equal(a, b), name
    (s1, d1), (s2, d2) = (optimize_window(cfg, imu, intr, problem) for _ in range(2))
    for name, a, b in zip(s1._fields, s1, s2):
        assert (a is None and b is None) or torch.equal(a, b), name
    assert torch.equal(d1.accepted, d2.accepted) and torch.equal(d1.cost_history, d2.cost_history)


def test_estimator_on_the_card_matches_cpu_float64(cuda):
    """Six frames of chip_smoke.py's estimator scenario through add_states /
    optimize / marginalize on the card in float32, against the port's
    float64 CPU run of the same frames; the prior stays on the card."""
    from chip_smoke import ESTIMATOR_GATES, estimator_frames, estimator_window, run_estimator

    frames, init = estimator_frames()
    est, rows, _ = run_estimator("optimize", "cuda", torch.float32, frames[:6], init)
    ref_est, ref_rows, _ = run_estimator("optimize", "cpu", torch.float64, frames[:6], init)
    assert [r["tier"] for r in rows] == [r["tier"] for r in ref_rows]
    assert isinstance(est.marg_H, torch.Tensor) and est.marg_H.device.type == "cuda" and est.marg_valid
    win, ref = estimator_window(est), estimator_window(ref_est)
    assert win["slots"] == ref["slots"]
    tol_m, _ = ESTIMATOR_GATES["optimize"]["f64"]
    sl = win["slots"]
    assert np.abs(win["r_WS"][sl] - ref["r_WS"][sl]).max() < tol_m


_ASSOC_ORDER = ("desc_a", "sel3d", "hp", "free2", "uv_a", "std_a", "T_WS_b", "sb_b", "T_WC_a", "desc_b", "free_b",
                "uv_b", "std_b", "sel_prev", "pts_prev", "T_SC")


def _association_call(d, u, device, dtype):
    """A call of associate_multicam on the scene's numpy inputs, uploaded to
    `device` now, with the geometry in `dtype` and the stereo pair riding
    the round."""
    from okvis_tpu_torch.cameras.pinhole import CameraSpec
    from okvis_tpu_torch.frontend.kernels import associate_multicam
    from okvis_tpu_torch.kinematics import SE3

    def t(x):
        x = np.asarray(x)
        x = torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(device)
        return x.to(dtype) if x.is_floating_point() else x

    args = [SE3(r=t(d[k][0]), q=t(d[k][1])) if k.startswith("T_") else t(d[k]) for k in _ASSOC_ORDER]
    u, intr = t(u), t(d["intr"])  # every input on the device before the call
    return lambda: associate_multicam(CameraSpec(*d["spec"]), u, intr, *args, 40.0, 9.0, stereo_pairs=((0, 1),))


@pytest.fixture(scope="module")
def association_round():
    """The association scene at the estimator's width: P = 4 sources, 2
    cameras, K = 400 keypoint slots (the (8, 400, 400) Hamming batch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.synthetic import association_scene, euroc_stereo_rig

    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    d = association_scene(NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr), P=4, K=400)
    u = np.random.default_rng(1).uniform(size=(2, 64, 3))
    return d, u


def test_association_on_the_card_matches_cpu_float64(association_round):
    """The round in float32 on the card against the port's float64 CPU run:
    on this well-separated scene (true matches 6 bits apart, others ~256)
    the assignments, the stereo assignment and the RANSAC verdict agree."""
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    d, u = association_round
    before = hamming_matrix_cuda.launches
    card = _association_call(d, u, "cuda", torch.float32)()
    assert hamming_matrix_cuda.launches == before + 3  # 3D-2D, 2D-2D, the stereo pair
    cpu = _association_call(d, u, "cpu", torch.float64)()
    for i in (0, 1):
        assert torch.equal(card[i].cpu(), cpu[i]), i
    assert torch.equal(card[9][0].cpu(), cpu[9][0])
    assert (cpu[0] >= 0).sum() > 100 and bool(card[8]) == bool(cpu[8])
    assert abs(int(card[7]) - int(cpu[7])) <= 2


def test_association_on_the_card_has_no_host_sync(association_round):
    d, u = association_round
    call = _association_call(d, u, "cuda", torch.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_association_on_the_card_is_bitwise_repeatable(association_round):
    d, u = association_round
    call = _association_call(d, u, "cuda", torch.float32)
    a, b = call(), call()
    flat = lambda out: [*out[:9], *out[9]]  # noqa: E731
    for i, (x, y) in enumerate(zip(flat(a), flat(b))):
        assert torch.equal(x, y), i


def _stub_runtime(device, dtype, n_frames=6, K=64):
    """The port's ThreadedVio in blocking mode on `device` for n_frames
    keypoint frames of test_torch_threaded_vio.py's world behind a stub
    detector, with the RANSAC uniforms drawn from one host generator on
    both devices (the card's and the CPU's generators differ)."""
    from okvis_tpu_torch import convert
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.config import VioParameters
    from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, keypoint_frames, make_landmarks, simulate_trajectory
    from okvis_tpu_torch.pipeline import ThreadedVio
    from okvis_tpu_torch.utils.ids import IdProvider

    traj = simulate_trajectory(duration=1.2, seed=31, motion_scale=0.25)
    lms = make_landmarks(traj, 600, seed=32, radius=(4.0, 8.0))
    specs, T_SC, intr = euroc_stereo_rig(device=device)
    rig = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)
    rig.compute_overlaps()
    frames = iter(keypoint_frames(traj, lms, rig, n_frames, K, seed=3))
    params = VioParameters()
    params.optimization.max_num_keypoints = K
    IdProvider.reset()
    vio = ThreadedVio(params, rig=rig, blocking=True, dtype=dtype, device=device)
    rng = np.random.default_rng(7)

    def draw(shape, high=None):
        if high is not None:
            return int(rng.integers(0, high))
        return torch.from_numpy(rng.uniform(size=shape)).to(device=device, dtype=rig.dtype)

    def detect(images, T_WS=None):
        f = next(frames)
        return [convert.frame_from_numpy(f.uv[c], np.ones(K), f.mask[c], f.descriptors[c], np.zeros(K, np.int64),
                                         device=device, dtype=torch.float32) for c in range(len(images))]

    vio.frontend._draw = draw
    vio.frontend.detect_and_describe_multi = detect
    ts_ns = (traj.ts * 1e9).astype(np.int64)
    imu_i = 0
    for fi in range(n_frames):
        t_ns = int(fi * 0.1 * 1e9)
        while imu_i < len(ts_ns) and ts_ns[imu_i] <= t_ns + 25_000_000:
            vio.add_imu_measurement(int(ts_ns[imu_i]), traj.gyro[imu_i], traj.acc[imu_i])
            imu_i += 1
        vio.add_image(t_ns, 0, None)
        vio.add_image(t_ns, 1, None)
        vio.wait_idle(timeout=120)
    vio.shutdown()
    return vio


def test_runtime_on_the_card_matches_cpu_float64(cuda):
    """Six stub-detector frames through ThreadedVio on the card in float32,
    against the port's float64 CPU run, within the estimator test's
    position tolerance; the card run keeps its prior and propagation on the
    card."""
    from chip_smoke import ESTIMATOR_GATES

    card = _stub_runtime("cuda", torch.float32)
    ref = _stub_runtime("cpu", torch.float64)
    assert [(s.timestamp_ns, s.is_keyframe) for s in card.trajectory] == \
        [(s.timestamp_ns, s.is_keyframe) for s in ref.trajectory]
    assert len(card.trajectory) == 6 and card.frontend.is_initialized == ref.frontend.is_initialized
    tol_m, _ = ESTIMATOR_GATES["optimize"]["f64"]
    for a, b in zip(card.trajectory, ref.trajectory):
        assert np.abs(a.T_WS.r.numpy() - b.T_WS.r.numpy()).max() < tol_m
    assert isinstance(card.estimator.marg_H, torch.Tensor) and card.estimator.marg_H.device.type == "cuda"


def test_pose_graph_on_the_card_matches_cpu_and_repeats(cuda):
    """The drifting circle at 64 nodes (dense) and 400 (PCG) solved on the
    card: bitwise equal twice, and equal to the CPU's float64 solve to
    1e-9; one keyframe-database query equal to the CPU's."""
    from okvis_tpu_torch.datasets.synthetic import circle_pose_graph, fill_pose_graph
    from okvis_tpu_torch.posegraph.graph import PoseGraph
    from okvis_tpu_torch.posegraph.place_recognition import KeyframeDatabase

    for n in (64, 400):
        spec = circle_pose_graph(n)
        runs = [fill_pose_graph(PoseGraph(n, 2 * n, device=d), spec).optimize(max_iterations=8, pcg_iters=60)
                for d in ("cuda", "cuda", "cpu")]
        for k in ("node_r", "node_q", "final_cost", "iterations"):
            assert torch.equal(getattr(runs[0], k), getattr(runs[1], k)), (n, k)
            np.testing.assert_allclose(getattr(runs[0], k).cpu().numpy(), getattr(runs[2], k).numpy(), rtol=1e-9,
                                       atol=1e-9)
    rng = np.random.default_rng(3)
    dbs = [KeyframeDatabase(32, 64, desc_words=16, desc_dtype=np.uint32, device=d) for d in ("cuda", "cpu")]
    for i in range(20):
        desc, mask = rng.integers(0, 2**32, (64, 16), dtype=np.uint32), rng.uniform(size=64) < 0.9
        for db in dbs:
            db.insert(i, desc, mask, np.zeros((64, 3)), np.zeros((64, 3)), np.ones(64, bool))
    q = dbs[0].desc[5].copy()
    got, want = (db.query(q, np.ones(64, bool), {19}) for db in dbs)
    assert got[:2] == want[:2] and got[0] == 5
    np.testing.assert_array_equal(got[2], want[2])


def test_euroc_app_runs_on_the_card(cuda, tmp_path):
    """apps.run_euroc.run on a 6-frame dataset the port writes (the
    revisit world at the EuRoC rig), on the card in float32 with loop
    closure and parameters built in code: every frame processed, both
    kernels launched, the ATE under tests/test_euroc_app.py's 0.2 m."""
    from chip_smoke import app_params, modes_rig
    from okvis_tpu_torch.apps.run_euroc import run
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, revisit_world, write_euroc_format
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    traj, lms = revisit_world(6)
    mav0 = write_euroc_format(str(tmp_path / "ds"), traj, lms, NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr),
                              n_frames=6)
    rig = modes_rig("runtime", "cuda")
    h0, m0 = harris_suppressed_cuda.launches, hamming_matrix_cuda.launches
    out = run(app_params(rig), mav0, dtype=torch.float32, trajectory_out=str(tmp_path / "t.tum"), rig=rig,
              loop_closure=True, device="cuda", decoder="python")
    assert out["frames_processed"] == out["frames_fed"] == 6
    assert harris_suppressed_cuda.launches - h0 == 6 and hamming_matrix_cuda.launches > m0
    assert out["ate_rmse_m"] is not None and out["ate_rmse_m"] < 0.2
    assert out["posegraph_keyframes"] >= 2 and (tmp_path / "t.tum.loop").exists()
