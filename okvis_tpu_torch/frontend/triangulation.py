"""Two-view triangulation, closed-form midpoint, branch-free over a batch
(port of okvis_tpu.frontend.triangulation).

2x2 midpoint solve between two rays, parallel-ray fallback (point at
infinity with w=1e-3), chi²>9 rejection and the sign flip, written with
torch.where so a whole batch of candidate matches triangulates at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TriangulationResult(NamedTuple):
    hp: torch.Tensor  # (..., 4) normalized homogeneous point
    valid: torch.Tensor  # (...,) bool
    parallel: torch.Tensor  # (...,) bool


def triangulate_fast(
    p1: torch.Tensor,  # (..., 3) camera-1 center
    e1: torch.Tensor,  # (..., 3) ray direction 1
    p2: torch.Tensor,  # (..., 3) camera-2 center
    e2: torch.Tensor,  # (..., 3) ray direction 2
    sigma: torch.Tensor,  # (...,) ray uncertainty
) -> TriangulationResult:
    t12 = p2 - p1
    b0 = torch.sum(t12 * e1, dim=-1)
    b1 = torch.sum(t12 * e2, dim=-1)
    a00 = torch.sum(e1 * e1, dim=-1)
    a10 = torch.sum(e1 * e2, dim=-1)
    a01 = -a10
    a11 = -torch.sum(e2 * e2, dim=-1)
    # wrong viewing direction flip
    flip = a10 < 0.0
    a10 = torch.where(flip, -a10, a10)
    a01 = torch.where(flip, -a01, a01)

    det = a00 * a11 - a01 * a10
    invertible = det.abs() > 1e-6
    safe_det = torch.where(invertible, det, torch.ones_like(det))
    l0 = (a11 * b0 - a01 * b1) / safe_det
    l1 = (-a10 * b0 + a00 * b1) / safe_det

    xm = l0[..., None] * e1 + p1
    xn = l1[..., None] * e2 + p2
    midpoint = 0.5 * (xm + xn)

    err = midpoint - xm
    diff = midpoint - (p1 + 0.5 * t12)
    diff_sq = torch.sum(diff * diff, dim=-1)
    chi2 = torch.sum(err * err, dim=-1) / torch.clamp(diff_sq * sigma * sigma, min=1e-300)
    valid_mid = chi2 <= 9.0

    # sign flip toward the viewing direction
    flip2 = torch.sum(diff * e1, dim=-1) < 0
    midpoint = torch.where(flip2[..., None], (p1 + 0.5 * t12) - diff, midpoint)
    hp_mid = torch.cat([midpoint, torch.ones_like(midpoint[..., :1])], dim=-1)
    hp_mid = hp_mid / torch.linalg.norm(hp_mid, dim=-1, keepdim=True)

    # parallel fallback: direction average at infinity, w = 1e-3
    mean_dir = 0.5 * (e1 + e2)
    hp_par = torch.cat([mean_dir, torch.full_like(mean_dir[..., :1], 1e-3)], dim=-1)
    hp_par = hp_par / torch.linalg.norm(hp_par, dim=-1, keepdim=True)
    cross_norm = torch.linalg.norm(torch.linalg.cross(e1, e2, dim=-1), dim=-1)
    valid_par = cross_norm < 6.0 * sigma

    hp = torch.where(invertible[..., None], hp_mid, hp_par)
    valid = torch.where(invertible, valid_mid, valid_par)
    return TriangulationResult(hp=hp, valid=valid, parallel=~invertible)


def refine_triangulation(
    project_residual,  # fn(hp (4,)) -> (n_res,) stacked reprojection residuals
    hp0: torch.Tensor,  # (4,) initial homogeneous point
    iters: int = 5,
) -> TriangulationResult:
    """Small Gauss-Newton refinement of one triangulated point over its
    observations, poses held fixed (their uncertainty enters through the
    measurement sigmas baked into `project_residual`). Optimizes the first
    three homogeneous coordinates; validity from the final chi²."""
    hp = hp0
    eye = torch.eye(3, dtype=hp0.dtype, device=hp0.device)
    for _ in range(iters):
        r = project_residual(hp)
        J = torch.func.jacfwd(project_residual)(hp)[:, :3]  # (n, 3)
        H = J.T @ J + 1e-9 * eye
        g = J.T @ r
        # 3x3 solve via adjugate
        a, b, c = H[0, 0], H[0, 1], H[0, 2]
        d, e, f = H[1, 1], H[1, 2], H[2, 2]
        det = a * (d * f - e * e) - b * (b * f - e * c) + c * (b * e - d * c)
        inv_det = 1.0 / torch.where(det.abs() < 1e-18, torch.ones_like(det), det)
        Hinv = torch.stack(
            [
                torch.stack([d * f - e * e, c * e - b * f, b * e - c * d]),
                torch.stack([c * e - b * f, a * f - c * c, b * c - a * e]),
                torch.stack([b * e - c * d, b * c - a * e, a * d - b * b]),
            ]
        ) * inv_det
        hp = torch.cat([hp[:3] - Hinv @ g, hp[3:]])
    r = project_residual(hp)
    chi2 = torch.sum(r * r)
    n_res = r.shape[0]
    return TriangulationResult(
        hp=hp / torch.linalg.norm(hp),
        valid=chi2 < 9.0 * (n_res / 2),
        parallel=torch.zeros((), dtype=torch.bool, device=hp.device),
    )
