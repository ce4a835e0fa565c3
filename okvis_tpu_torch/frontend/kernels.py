"""Fixed-shape frontend programs, stereo subset (port of okvis_tpu.frontend.kernels).

Matching, projection and two-view triangulation over fixed-capacity padded
batches of keypoints. ``associate_multicam``, ``gated_match_pairs`` and
``ransac_2d2d_px`` are not ported yet.
"""

from __future__ import annotations

import torch

from .. import kinematics as kin
from ..cameras import pinhole
from ..cameras.pinhole import CameraSpec
from ..ops.hamming import masked_distance_matrix, mutual_best_assignment
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
    uv_a: torch.Tensor,  # (K, 2) paired keypoints
    uv_b: torch.Tensor,  # (K, 2)
    pair_mask: torch.Tensor,  # (K,)
    std_a: torch.Tensor,  # (K,) keypoint stddev in A [px] (0.8·size/12)
    std_b: torch.Tensor,  # (K,) paired keypoint stddev in B [px]
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

    Pixel coordinates are computed in the dtype of uv_a (the JAX package
    promotes them to the intrinsics' dtype; pass uv in that dtype).
    Returns (hp_W (K,4), valid (K,), parallel (K,), can_init (K,))."""
    rays_a = pinhole.back_project(spec_a, intr_a, uv_a)
    rays_b = pinhole.back_project(spec_b, intr_b, uv_b)
    e_a = kin.quat_rotate(T_WC_a.q[None], rays_a)
    e_a = e_a / torch.linalg.norm(e_a, dim=-1, keepdim=True)
    e_b = kin.quat_rotate(T_WC_b.q[None], rays_b)
    e_b = e_b / torch.linalg.norm(e_b, dim=-1, keepdim=True)
    sigma = (
        _SQRT_SQRT2 * torch.maximum(std_a, std_b) / torch.minimum(intr_a[0], intr_b[0])
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
        J = pinhole.project_homogeneous_jacobian(spec, intr, hp_C)[:, :, :3]
        return uv, flags == pinhole.STATUS_OK, J

    proj_a, ok_a, _ = reproject(T_CW_a, spec_a, intr_a, out.hp)
    proj_b, ok_b, J_b = reproject(T_CW_b, spec_b, intr_b, out.hp)
    err_a = proj_a - uv_a
    chi2_a = torch.sum(err_a * err_a, dim=-1) / torch.clamp(std_a * std_a, min=1e-12)
    # U_B = stdB²·I + σt²·J·Jᵀ (2×2), closed-form inverse quadratic form
    err_b = proj_b - uv_b
    U = sigma_t2 * torch.einsum("kia,kja->kij", J_b, J_b)
    u11 = U[:, 0, 0] + std_b * std_b
    u22 = U[:, 1, 1] + std_b * std_b
    u12 = U[:, 0, 1]
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
        std_a, std_b[ib], torch.tensor(4e-8, dtype=uv_a.dtype, device=uv_a.device),
    )
    return assign, hp, valid, par, can_init
