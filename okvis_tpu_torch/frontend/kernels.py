"""Fixed-shape frontend programs (port of okvis_tpu.frontend.kernels).

Matching, projection, chi²-gated 3D-2D association, 2D-2D association with
triangulation, the folded rig RANSAC and the bootstrap's 2D-2D RANSAC, over
fixed-capacity padded batches of keypoints. Where the JAX package vmaps
over source frames and cameras, these functions batch over a leading
(P·C) axis, so each round is one Hamming kernel launch on the card
(``ops.hamming.masked_distance_matrix``).

Randomness comes in as uniform draws (see ``frontend.ransac``). The
association (``associate_multicam``, ``associate_onecam``,
``gated_match_pairs``) makes no host sync on CUDA; ``ransac_2d2d_px``
syncs in its SVD and eigh calls.
"""

from __future__ import annotations

import torch

from .. import kinematics as kin
from ..cameras import pinhole
from ..cameras.pinhole import CameraSpec
from ..ops.hamming import MAX_DIST, masked_distance_matrix, mutual_best_assignment
from .ransac import ransac_absolute_rig, ransac_relative_pose, ransac_rotation_only
from .triangulation import triangulate_fast

_SQRT_SQRT2 = 1.189207115002721  # sqrt(sqrt(2)), ref raySigma scale


def plain_match(desc_a, desc_b, mask_a, mask_b, threshold: int = 60) -> torch.Tensor:
    dist = masked_distance_matrix(desc_a, desc_b, mask_a, mask_b)
    return mutual_best_assignment(dist, threshold)


def project_hpoints(spec: CameraSpec, intrinsics: torch.Tensor, T_CW: kin.SE3, hp_W: torch.Tensor):
    """Project (K, 4) homogeneous world points -> ((K,2) uv, (K,) ok)."""
    hp_C = kin.transform_hpoint(T_CW, hp_W)
    uv, flags = pinhole.project_homogeneous(spec, intrinsics, hp_C)
    return uv, flags == pinhole.STATUS_OK


def project_points(spec: CameraSpec, intrinsics: torch.Tensor, T_CW: kin.SE3, p_W: torch.Tensor):
    """Project (K, 3) world points -> ((K,2) uv, (K,) ok)."""
    p_C = kin.transform_point(T_CW, p_W)
    uv, flags = pinhole.project(spec, intrinsics, p_C)
    return uv, flags == pinhole.STATUS_OK


def triangulate_pairs(
    spec_a: CameraSpec,
    spec_b: CameraSpec,
    intr_a: torch.Tensor,
    intr_b: torch.Tensor,
    T_WC_a: kin.SE3,
    T_WC_b: kin.SE3,
    uv_a: torch.Tensor,  # (..., K, 2) paired keypoints
    uv_b: torch.Tensor,  # (..., K, 2)
    pair_mask: torch.Tensor,  # (..., K)
    std_a: torch.Tensor,  # (..., K) keypoint stddev in A [px] (0.8·size/12)
    std_b: torch.Tensor,  # (..., K) paired keypoint stddev in B [px]
    sigma_t2: torch.Tensor,  # scalar: relative-pose translation variance [m²]
):
    """Batched two-view triangulation of matched keypoint pairs with the
    reference ProbabilisticStereoTriangulator's gates:

    - ray sigma = √√2 · max(stdA, stdB) / min(fuA, fuB) per pair, feeding
      triangulate_fast's parallel/chi² decisions;
    - reprojection chi² ≤ 4 in both frames, with the relative-pose
      translation covariance folded into frame B's gate covariance
      U_B = stdB²·I + σt²·J_B·J_Bᵀ;
    - depth observability: move the point 80% toward the baseline midpoint
      and reproject; if the residual stays < 4 the depth is unobservable
      → can_init=False.

    A leading batch (..., K) triangulates several frame pairs at once (the
    JAX package's vmap): poses then carry (..., 1, 3) / (..., 1, 4) and the
    intrinsics (..., 1, N). Pixel coordinates are computed in the dtype of
    uv_a (the JAX package promotes them to the intrinsics' dtype; pass uv in
    that dtype). Returns (hp_W (...,K,4), valid, parallel, can_init
    (...,K))."""
    rays_a = pinhole.back_project(spec_a, intr_a, uv_a)
    rays_b = pinhole.back_project(spec_b, intr_b, uv_b)
    e_a = kin.quat_rotate(T_WC_a.q, rays_a)
    e_a = e_a / torch.linalg.norm(e_a, dim=-1, keepdim=True)
    e_b = kin.quat_rotate(T_WC_b.q, rays_b)
    e_b = e_b / torch.linalg.norm(e_b, dim=-1, keepdim=True)
    sigma = (
        _SQRT_SQRT2 * torch.maximum(std_a, std_b) / torch.minimum(intr_a[..., 0], intr_b[..., 0])
    ).to(uv_a.dtype)
    out = triangulate_fast(
        T_WC_a.r.expand_as(e_a), e_a, T_WC_b.r.expand_as(e_b), e_b, sigma
    )

    # ---- reprojection gates in both frames (chi² ≤ 4) ----
    T_CW_a = kin.inverse(T_WC_a)
    T_CW_b = kin.inverse(T_WC_b)

    def reproject(T_CW, spec, intr, hp):
        hp_C = kin.transform_hpoint(T_CW, hp)
        uv, flags = pinhole.project_homogeneous(spec, intr, hp_C)
        J = pinhole.project_homogeneous_jacobian(spec, intr, hp_C)[..., :3]
        return uv, flags == pinhole.STATUS_OK, J

    proj_a, ok_a, _ = reproject(T_CW_a, spec_a, intr_a, out.hp)
    proj_b, ok_b, J_b = reproject(T_CW_b, spec_b, intr_b, out.hp)
    err_a = proj_a - uv_a
    chi2_a = torch.sum(err_a * err_a, dim=-1) / torch.clamp(std_a * std_a, min=1e-12)
    # U_B = stdB²·I + σt²·J·Jᵀ (2×2), closed-form inverse quadratic form
    err_b = proj_b - uv_b
    U = sigma_t2 * torch.einsum("...ia,...ja->...ij", J_b, J_b)
    u11 = U[..., 0, 0] + std_b * std_b
    u22 = U[..., 1, 1] + std_b * std_b
    u12 = U[..., 0, 1]
    det = torch.clamp(u11 * u22 - u12 * u12, min=1e-12)
    e0, e1 = err_b[..., 0], err_b[..., 1]
    chi2_b = (u22 * e0 * e0 - 2.0 * u12 * e0 * e1 + u11 * e1 * e1) / det
    valid = out.valid & pair_mask & ok_a & ok_b & (chi2_a <= 4.0) & (chi2_b <= 4.0)

    # ---- depth observability ("evaluate again closer") ----
    mid_W = 0.5 * (T_WC_a.r + T_WC_b.r)  # baseline midpoint
    w = out.hp[..., 3:4]
    closer = torch.cat([0.8 * (out.hp[..., :3] - mid_W * w) + mid_W * w, w], dim=-1)
    proj_c, ok_c, _ = reproject(T_CW_b, spec_b, intr_b, closer)
    err_c = proj_c - uv_b
    chi2_c = torch.sum(err_c * err_c, dim=-1) / torch.clamp(std_b * std_b, min=1e-12)
    can_init = (~out.parallel) & (ok_c & (chi2_c >= 4.0))
    return out.hp, valid, out.parallel, can_init


def back_project_batch(spec: CameraSpec, intrinsics: torch.Tensor, uv: torch.Tensor):
    """(K,2) pixels -> (K,3) unit bearings in camera frame."""
    rays = pinhole.back_project(spec, intrinsics, uv)
    return rays / torch.linalg.norm(rays, dim=-1, keepdim=True)


def stereo_match_triangulate(
    spec_a: CameraSpec,
    spec_b: CameraSpec,
    intr_a: torch.Tensor,
    intr_b: torch.Tensor,
    desc_a: torch.Tensor,  # (K, 16)
    desc_b: torch.Tensor,  # (K, 16)
    free_a: torch.Tensor,  # (K,)
    free_b: torch.Tensor,  # (K,)
    uv_a: torch.Tensor,  # (K, 2)
    uv_b: torch.Tensor,  # (K, 2)
    T_WC_a: kin.SE3,
    T_WC_b: kin.SE3,
    std_a: torch.Tensor,  # (K,) keypoint stddev [px]
    std_b: torch.Tensor,  # (K,)
    threshold: int = 60,
):
    """Intra-multiframe stereo matching + triangulation. A same-frame pair:
    the relative extrinsics carry the reference's fixed 4e-8 translation
    variance. Returns (assign (K,), hp_W (K,4), valid (K,), parallel (K,),
    can_init (K,))."""
    assign = plain_match(desc_a, desc_b, free_a, free_b, threshold=threshold)
    pmask = assign >= 0
    ib = torch.where(pmask, assign, 0)
    hp, valid, par, can_init = triangulate_pairs(
        spec_a, spec_b, intr_a, intr_b, T_WC_a, T_WC_b, uv_a, uv_b[ib], pmask,
        std_a, std_b[ib], torch.full((), 4e-8, dtype=uv_a.dtype, device=uv_a.device),
    )
    return assign, hp, valid, par, can_init


# ---------------------------------------------------------------------------
# association: gated 3D-2D and 2D-2D matching of source frames against the
# current frame, every (source, camera) task of a round in one batch
# ---------------------------------------------------------------------------


def _project_hpoints_with_cov(
    spec: CameraSpec,
    intrinsics: torch.Tensor,  # (N,) or (..., 1, N)
    T_CW: kin.SE3,  # broadcastable to hp_W's batch
    hp_W: torch.Tensor,  # (..., K, 4)
    sigma_pos2,  # scalar: isotropic position variance [m²]
):
    """Project landmarks and propagate an isotropic position uncertainty to a
    2×2 image covariance (ref VioKeyframeWindowMatchingAlgorithm::doSetup,
    VioKeyframeWindowMatchingAlgorithm.cpp:199-209: U = J·P_C·Jᵀ with
    P_C = σ²·I on the position block). Returns (uv (...,K,2), cov
    (...,K,2,2), ok (...,K))."""
    hp_C = kin.transform_hpoint(T_CW, hp_W)
    uv, flags = pinhole.project_homogeneous(spec, intrinsics, hp_C)
    Jp = pinhole.project_homogeneous_jacobian(spec, intrinsics, hp_C)[..., :3]
    cov = sigma_pos2 * torch.einsum("...ia,...ja->...ij", Jp, Jp)
    return uv, cov, flags == pinhole.STATUS_OK


def _chi2_gate(
    pred_uv: torch.Tensor,  # (..., K, 2) predicted projections (A rows)
    pred_cov: torch.Tensor,  # (..., K, 2, 2) projection covariance (A rows)
    uv_b: torch.Tensor,  # (..., K, 2) current-frame keypoints
    std_b: torch.Tensor,  # (..., K) current-frame keypoint stddev [px]
    gate_ok: torch.Tensor,  # (..., K) valid A rows
) -> torch.Tensor:
    """(..., K_A, K_B) chi² of the 3D-2D association test err·U⁻¹·err with
    U = std_b²·I + pred_cov (ref verifyMatch chi² < 4 gate,
    VioKeyframeWindowMatchingAlgorithm.cpp:318-336); inf on invalid rows."""
    err = pred_uv[..., :, None, :] - uv_b[..., None, :, :]  # (..., A, B, 2)
    s2 = (std_b * std_b)[..., None, :]  # (..., 1, B)
    u11 = pred_cov[..., :, None, 0, 0] + s2
    u22 = pred_cov[..., :, None, 1, 1] + s2
    u12 = pred_cov[..., :, None, 0, 1].expand_as(u11)
    det = torch.clamp(u11 * u22 - u12 * u12, min=1e-12)
    e0, e1 = err[..., 0], err[..., 1]
    chi2 = (u22 * e0 * e0 - 2.0 * u12 * e0 * e1 + u11 * e1 * e1) / det
    return torch.where(gate_ok[..., :, None], chi2, torch.inf)


def _gated_distances(spec, intr, T_CW, hp, sel, desc_a, desc_b, mask_b, uv_b, std_b, sigma_pos2,
                     gate_radius: float):
    """(G, K, K) distances of the 3D-2D round: the Hamming matrix of the
    selected source rows against the mask_b keypoints (one kernel launch on
    the card), MAX_DIST where chi² ≥ 4 or, when gate_radius > 0, beyond
    that many pixels of the prediction. Returns (dist, gate_ok (G, K))."""
    uv_pred, cov, ok = _project_hpoints_with_cov(spec, intr, T_CW, hp, sigma_pos2)
    gate_ok = sel & ok
    chi2 = _chi2_gate(uv_pred, cov, uv_b, std_b, gate_ok)
    dist = masked_distance_matrix(desc_a, desc_b, gate_ok, mask_b)
    dist = torch.where(chi2 >= 4.0, MAX_DIST, dist)
    if gate_radius > 0:
        # optional coarse disc cap (the reference has none)
        pred = torch.where(gate_ok[..., None], uv_pred, 1e9)
        d2 = torch.sum((pred[..., :, None, :] - uv_b[..., None, :, :]) ** 2, dim=-1)
        dist = torch.where(d2 > gate_radius * gate_radius, MAX_DIST, dist)
    return dist, gate_ok


def gated_match_pairs(
    spec: CameraSpec,
    intrinsics: torch.Tensor,  # (N,)
    desc_a: torch.Tensor,  # (P, K, 16) source descriptors per pair
    mask_a: torch.Tensor,  # (P, K)
    hp_rows: torch.Tensor,  # (P, K, 4) landmark homogeneous points per A row
    T_CW: kin.SE3,  # batched (P,...) current-frame camera-from-world per pair
    desc_b: torch.Tensor,  # (K, 16) current-frame descriptors (shared)
    mask_b: torch.Tensor,  # (K,)
    uv_b: torch.Tensor,  # (K, 2)
    std_b: torch.Tensor,  # (K,) current keypoint stddev [px]
    sigma_pos2,  # scalar position variance for the chi² gate
    gate_radius: float,  # coarse pixel cap on top of chi² (<= 0: off)
    threshold: int = 60,
):
    """3D-2D chi²-gated matching of P source frames against the current frame
    in one batch (the conflict-loser recovery round): one (P, K, K) Hamming
    launch. Returns (assign (P, K), pred_ok (P, K))."""
    P = desc_a.shape[0]
    # the kernel takes contiguous rows: a camera's slice of (P, C, K, 16) is not
    dist, gate_ok = _gated_distances(
        spec, intrinsics, kin.SE3(r=T_CW.r[:, None], q=T_CW.q[:, None]), hp_rows, mask_a, desc_a.contiguous(),
        desc_b.expand(P, -1, -1).contiguous(), mask_b.expand(P, -1).contiguous(), uv_b, std_b,
        sigma_pos2, gate_radius)
    return mutual_best_assignment(dist, threshold), gate_ok


def _claims(assign: torch.Tensor, ok: torch.Tensor, K: int) -> torch.Tensor:
    """(C, K) bool: keypoints of camera c that some source row claims, from
    (P, C, K) assignments where ok; an order-free int32 scatter into a K + 1
    buffer whose last column takes the unclaimed rows."""
    P, C, _ = assign.shape
    idx = torch.where(ok, assign, K) + (K + 1) * torch.arange(C, device=assign.device)[:, None]
    hits = torch.zeros(C * (K + 1), dtype=torch.int32, device=assign.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.int32, device=assign.device))
    return hits.view(C, K + 1)[:, :K] > 0


def _newest_claim_points(assign3: torch.Tensor, hp_rows: torch.Tensor, K: int) -> torch.Tensor:
    """(C, K, 3) world points of the landmark claiming each current keypoint:
    where several sources claim one keypoint the newest (lowest source
    index) wins, as the JAX package's reversed in-order scatter gives it.
    Resolved explicitly (the lowest flat row p·K + ia by an amin scatter,
    then a gather), so the result does not depend on the order in which a
    device applies duplicate writes. Unclaimed keypoints get 0."""
    P, C, _ = assign3.shape
    dev = assign3.device
    w = hp_rows[..., 3]
    pts = hp_rows[..., :3] / torch.where(w.abs() < 1e-8, 1.0, w)[..., None]  # (P, C, K, 3)
    pts = pts.permute(1, 0, 2, 3).reshape(C, P * K, 3)
    hit = assign3 >= 0
    src_row = (torch.arange(P, device=dev)[:, None, None] * K + torch.arange(K, device=dev)).expand(P, C, K)
    tgt = torch.where(hit, assign3, K) + (K + 1) * torch.arange(C, device=dev)[:, None]
    best = torch.full((C * (K + 1),), P * K, dtype=torch.int64, device=dev).scatter_reduce(
        0, tgt.reshape(-1), src_row.reshape(-1), reduce="amin").view(C, K + 1)[:, :K]
    got = torch.gather(pts, 1, torch.clamp(best, max=P * K - 1)[..., None].expand(C, K, 3))
    return torch.where((best < P * K)[..., None], got, 0.0)


def _prop_sigma_pos2(sb_b: torch.Tensor) -> torch.Tensor:
    """Velocity-scaled position variance for the chi² gate, from the
    propagated speed/bias on the device (ref doSetup :131-141:
    σ² = max(1,|v|)²·1e-2)."""
    s = torch.clamp(torch.linalg.norm(sb_b[:3]), min=1.0)
    return s * s * 1e-2


def _associate_cams(
    spec: CameraSpec,
    threshold: int,
    intr: torch.Tensor,  # (C, N)
    desc_a: torch.Tensor,  # (P, C, K, 16) source descriptors
    sel3d_a: torch.Tensor,  # (P, C, K) source rows carrying an INITIALIZED landmark
    hp_rows: torch.Tensor,  # (P, C, K, 4) landmark homogeneous points per row
    free2d_a: torch.Tensor,  # (P, C, K) source rows free for 2D-2D
    uv_a: torch.Tensor,  # (P, C, K, 2) source keypoints
    std_a: torch.Tensor,  # (P, C, K) source keypoint stddev [px]
    T_CW: kin.SE3,  # (C, ...) current camera-from-world
    T_WC_a: kin.SE3,  # (P, C, ...) source camera poses
    T_WC_b: kin.SE3,  # (C, ...) current camera poses
    desc_b: torch.Tensor,  # (C, K, 16)
    free_b: torch.Tensor,  # (C, K) free at round start
    uv_b: torch.Tensor,  # (C, K, 2)
    std_b: torch.Tensor,  # (C, K) current keypoint stddev [px]
    sel_prev: torch.Tensor,  # (C, K) current keypoints already carrying landmarks
    pts_prev: torch.Tensor,  # (C, K, 3) their world positions (RANSAC candidates)
    sigma_pos2,  # scalar position variance for the chi² gate
    gate_radius: float,  # coarse pixel cap on top of chi² (<= 0: off)
):
    """The body of a fused association round over C cameras of one model
    (the JAX package's _associate_onecam under a vmap over cameras), batched
    over G = P·C (source, camera) tasks: one Hamming launch for the 3D-2D
    round and one for the 2D-2D round."""
    P, C, K = sel3d_a.shape
    G = P * C

    def per_task(x):  # (C, ...) -> (G, 1, ...) repeated over sources
        return x[None].expand(P, *x.shape).reshape(G, 1, *x.shape[1:])

    def flat(x):  # (P, C, ...) -> (G, ...)
        return x.reshape(G, *x.shape[2:])

    intr_g = per_task(intr)
    desc_a_g = flat(desc_a).contiguous()  # a camera's slice (the per-camera round) is not
    uv_b_g = per_task(uv_b)[:, 0]
    std_b_g = per_task(std_b)[:, 0]
    desc_b_g = per_task(desc_b)[:, 0].contiguous()  # the kernel takes a batch of 1 or G

    # ---- 3D-2D gated matching, every (source, camera) in one launch ----
    dist, _ = _gated_distances(
        spec, intr_g, kin.SE3(r=per_task(T_CW.r), q=per_task(T_CW.q)), flat(hp_rows), flat(sel3d_a),
        desc_a_g, desc_b_g, per_task(free_b)[:, 0].contiguous(), uv_b_g, std_b_g, sigma_pos2,
        gate_radius)
    assign3 = mutual_best_assignment(dist, threshold).view(P, C, K)

    # post-3D-2D free mask: any source's claim removes the keypoint from the
    # 2D-2D pool (conservative against the host resolution, which may reject
    # individual claims: those keypoints skip this round's 2D-2D)
    hit3 = assign3 >= 0
    claimed = _claims(assign3, hit3, K)
    free_b2 = free_b & ~claimed

    # ---- candidate tables of the rig RANSAC: this round's claims (newest
    # source wins) merged with keypoints that already carried landmarks ----
    pts_b = torch.where(sel_prev[..., None], pts_prev, _newest_claim_points(assign3, hp_rows, K))
    ransac_sel = claimed | sel_prev
    bear_b = back_project_batch(spec, intr[:, None], uv_b)

    # ---- 2D-2D matching among the remaining free keypoints ----
    dist2 = masked_distance_matrix(desc_a_g, desc_b_g, flat(free2d_a).contiguous(),
                                   per_task(free_b2)[:, 0].contiguous())
    assign2 = mutual_best_assignment(dist2, threshold)  # (G, K)

    # ---- triangulate every 2D-2D assignment; the relative-pose prior
    # translation variance (velocity-scaled σ², ref doSetup :131-141) feeds
    # the gate covariance ----
    pmask = assign2 >= 0
    ib = torch.where(pmask, assign2, 0)
    uv_b_pair = torch.gather(uv_b_g, 1, ib[..., None].expand(G, K, 2))
    std_b_pair = torch.gather(std_b_g, 1, ib)
    T_WC_b_g = kin.SE3(r=per_task(T_WC_b.r), q=per_task(T_WC_b.q))
    hp, valid, par, can_init = triangulate_pairs(
        spec, spec, intr_g, intr_g, kin.SE3(r=flat(T_WC_a.r)[:, None], q=flat(T_WC_a.q)[:, None]),
        T_WC_b_g, flat(uv_a), uv_b_pair, pmask, flat(std_a), std_b_pair, sigma_pos2)
    assign2 = assign2.view(P, C, K)
    valid, par, can_init = (x.view(P, C, K) for x in (valid, par, can_init))

    # post-2D-2D free estimate (feeds the fused stereo matching): only valid
    # triangulations claim their keypoint
    free_b3 = free_b2 & ~_claims(assign2, (assign2 >= 0) & valid, K)
    return (assign3, assign2, hp.view(P, C, K, 4), valid, par, can_init, pts_b, ransac_sel, bear_b,
            free_b3)


def associate_onecam(
    spec, u, intr, desc_a, sel3d_a, hp_rows, free2d_a, uv_a, std_a,
    T_WS_b, sb_b, T_WC_a, desc_b, free_b, uv_b, std_b, sel_prev, pts_prev,
    T_SC, gate_radius, ransac_threshold_px2, threshold=60,
):
    """Fused association round for ONE camera (mixed-model rigs run one
    round per camera; the folded RANSAC then pools only this camera's
    correspondences). Inputs as associate_multicam's without the camera
    axis; u is (1, n_hyp, 3). The camera pose and gate variance are composed
    on the device from the propagated body state."""
    T_WC_b = kin.compose(T_WS_b, T_SC)
    T_CW = kin.inverse(T_WC_b)
    cam = lambda T: kin.SE3(r=T.r[None], q=T.q[None])  # noqa: E731
    src = lambda T: kin.SE3(r=T.r[:, None], q=T.q[:, None])  # noqa: E731
    out = _associate_cams(
        spec, threshold, intr[None], desc_a[:, None], sel3d_a[:, None], hp_rows[:, None],
        free2d_a[:, None], uv_a[:, None], std_a[:, None], cam(T_CW), src(T_WC_a), cam(T_WC_b),
        desc_b[None], free_b[None], uv_b[None], std_b[None], sel_prev[None], pts_prev[None],
        _prop_sigma_pos2(sb_b), gate_radius)
    assign3, assign2, hp, valid, par, can_init, pts_b, ransac_sel, bear_b, _f3 = out
    rr = ransac_absolute_rig(u, T_SC.r[None], T_SC.q[None], pts_b, bear_b, ransac_sel, intr[0][None],
                             threshold_px2=ransac_threshold_px2)
    return (assign3[:, 0], assign2[:, 0], hp[:, 0], valid[:, 0], par[:, 0], can_init[:, 0],
            rr.inliers[0], rr.num_inliers, rr.success)


def associate_multicam(
    spec: CameraSpec,
    u: torch.Tensor,  # (C, n_hyp, 3) uniform draws of the folded rig RANSAC
    intrinsics: torch.Tensor,  # (C, N)
    desc_a: torch.Tensor,  # (P, C, K, 16)
    sel3d_a: torch.Tensor,  # (P, C, K)
    hp_rows: torch.Tensor,  # (P, C, K, 4)
    free2d_a: torch.Tensor,  # (P, C, K)
    uv_a: torch.Tensor,  # (P, C, K, 2)
    std_a: torch.Tensor,  # (P, C, K) source keypoint stddev [px]
    T_WS_b: kin.SE3,  # current propagated body pose (may be device-resident)
    sb_b: torch.Tensor,  # (9,) propagated speed/bias (gate variance source)
    T_WC_a: kin.SE3,  # batched (P, C, ...) source camera poses
    desc_b: torch.Tensor,  # (C, K, 16)
    free_b: torch.Tensor,  # (C, K)
    uv_b: torch.Tensor,  # (C, K, 2)
    std_b: torch.Tensor,  # (C, K) current keypoint stddev [px]
    sel_prev: torch.Tensor,  # (C, K) keypoints already carrying landmarks
    pts_prev: torch.Tensor,  # (C, K, 3) their world positions
    T_SC: kin.SE3,  # batched (C,...) camera extrinsics
    gate_radius: float,
    ransac_threshold_px2: float,
    threshold: int = 60,
    stereo_pairs: tuple = (),
):
    """A complete data-association round, without a host sync: 3D-2D
    chi²-gated matching, the rig-level absolute-pose RANSAC over all
    cameras' 3D-2D associations, 2D-2D matching of the leftovers, and
    triangulation of every 2D-2D match, over all source frames and cameras
    of a rig of one camera model (ref matchToKeyframes + runRansac3d2d +
    matchToLastFrame, Frontend.cpp:153-233, 575-642). On the card: one
    (P·C, K, K) Hamming launch for each round, one (K, K) launch for each
    stereo pair.

    When `stereo_pairs` names overlapping camera pairs, intra-frame stereo
    matching + triangulation (matchStereo, Frontend.cpp:521-572) runs on the
    post-association free estimates in the same call; the host resolves it
    after the last-frame round (drop-on-conflict).

    Returns (assign3 (P,C,K), assign2 (P,C,K), hp_W (P,C,K,4),
    tri_valid (P,C,K), tri_parallel (P,C,K), tri_can_init (P,C,K),
    ransac_inliers (C,K), ransac_num_inliers (), ransac_success (),
    stereo (assign (S,K), hp (S,K,4), valid (S,K), parallel (S,K),
    can_init (S,K)))."""
    T_WC_b = kin.compose(kin.SE3(r=T_WS_b.r[None], q=T_WS_b.q[None]), T_SC)  # (C,)
    T_CW = kin.inverse(T_WC_b)
    (assign3, assign2, hp, valid, par, can_init, pts_b, ransac_sel, bear_b, free_b3) = _associate_cams(
        spec, threshold, intrinsics, desc_a, sel3d_a, hp_rows, free2d_a, uv_a, std_a, T_CW, T_WC_a, T_WC_b,
        desc_b, free_b, uv_b, std_b, sel_prev, pts_prev, _prop_sigma_pos2(sb_b), gate_radius)
    rr = ransac_absolute_rig(u, T_SC.r, T_SC.q, pts_b, bear_b, ransac_sel, intrinsics[:, 0],
                             threshold_px2=ransac_threshold_px2)
    stereo = [
        stereo_match_triangulate(
            spec, spec, intrinsics[ca], intrinsics[cb], desc_b[ca], desc_b[cb], free_b3[ca], free_b3[cb],
            uv_b[ca], uv_b[cb], kin.SE3(r=T_WC_b.r[ca], q=T_WC_b.q[ca]),
            kin.SE3(r=T_WC_b.r[cb], q=T_WC_b.q[cb]), std_b[ca], std_b[cb], threshold=threshold)
        for ca, cb in stereo_pairs
    ]
    if stereo:
        stereo_out = tuple(torch.stack([s[i] for s in stereo]) for i in range(5))
    else:
        K = free_b.shape[1]
        dev = free_b.device
        stereo_out = (torch.full((0, K), -1, dtype=torch.int64, device=dev),
                      torch.zeros((0, K, 4), dtype=hp.dtype, device=dev),
                      *(torch.zeros((0, K), dtype=torch.bool, device=dev) for _ in range(3)))
    return (assign3, assign2, hp, valid, par, can_init, rr.inliers, rr.num_inliers, rr.success,
            stereo_out)


def ransac_2d2d_px(
    u_rot: torch.Tensor,  # (n_hyp, 2) draws of the rotation-only RANSAC
    u_rel: torch.Tensor,  # (n_hyp, 8) draws of the relative-pose RANSAC
    spec: CameraSpec,
    intrinsics: torch.Tensor,
    uv_a: torch.Tensor,  # (K, 2)
    uv_b: torch.Tensor,  # (K, 2)
    mask: torch.Tensor,  # (K,)
    focal,
    threshold_px2,
):
    """Back-project both frames, then the rotation-only and the
    relative-pose RANSAC. Returns (rot_result, rel_result, bear_a, bear_b);
    the bearings feed the essential-matrix decomposition on init. Syncs on
    CUDA (SVD, eigh)."""
    bear_a = back_project_batch(spec, intrinsics, uv_a)
    bear_b = back_project_batch(spec, intrinsics, uv_b)
    rot = ransac_rotation_only(u_rot, bear_a, bear_b, mask, focal=focal, threshold_px2=threshold_px2)
    rel = ransac_relative_pose(u_rel, bear_a, bear_b, mask, focal=focal, threshold_px2=threshold_px2)
    return rot, rel, bear_a, bear_b
