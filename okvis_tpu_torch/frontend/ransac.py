"""Batched-hypothesis RANSAC for 3D-2D and 2D-2D geometric verification
(port of okvis_tpu.frontend.ransac).

Instead of a sequential hypothesize-and-verify loop, all hypotheses are
sampled, solved and scored against all correspondences at once: `n_hyp`
minimal solves, one (n_hyp × N) error matrix, then an argmax (first index on
ties, as in the JAX package). Minimal solvers are chosen for batching:

- rotation-only: 2-point Wahba (orthogonal Procrustes by a batched SVD);
- relative pose: 8-point essential matrix (batched eigh + SVD), scored by
  the Sampson error;
- absolute pose: 3-point Kneip P3P (a closed-form quartic solved in complex
  arithmetic, elementwise, so it batches over hypotheses and cameras);
  the 6-point DLT is kept as `_dlt_absolute_models` (coplanar-degenerate).

Randomness: every function takes its uniform draws in [0, 1) as a tensor
(`u`, shape (n_hyp, k), or (C, n_hyp, 3) for the rig) instead of a PRNG
key; `_sample_indices` maps them to indices exactly as the JAX package maps
its `jax.random.uniform` draws, so a caller holding JAX's draws replays its
hypotheses. n_hyp is u's hypothesis dim.

Host syncs on CUDA: none in the P3P path (`ransac_absolute_pose`,
`ransac_absolute_rig`). `torch.linalg.svd`, `eigh` and `det` check their
LAPACK info on the host, so the rotation-only, relative-pose, DLT and
`decompose_essential` paths sync (the bootstrap's 2D-2D RANSAC).

Error thresholds follow the reference's focal-scaled convention: pixel²
thresholds on angular or normalized-plane errors mapped through the focal
length.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kinematics import so3


class RansacResult(NamedTuple):
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # scalar int
    model: torch.Tensor  # solver-specific model parameters
    success: torch.Tensor  # scalar bool


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] along dim 0 for a 0-d index tensor, without a host read."""
    return x.index_select(0, i.reshape(1))[0]


def _sample_indices(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(..., k) indices of valid entries of the (N,) mask from uniform draws u:
    position min(int(u·n), N-1) among the n = max(Σmask, 1) valid entries in
    order (the JAX package's nonzero(size=N, fill_value=0) lookup: with no
    valid entry, index 0). Sync-free: a stable argsort of ~mask lists the
    valid entries first, in order, and starts at 0 when there is none."""
    N = mask.shape[-1]
    n = torch.clamp(mask.sum(dtype=torch.int64), min=1)
    pos = torch.clamp((u * n).to(torch.int32), max=N - 1).to(torch.int64)
    valid_idx = torch.argsort((~mask).to(torch.int8), stable=True)
    return valid_idx[pos]


# ---------------------------------------------------------------------------
# rotation-only 2-point (ref FrameRotationOnlySacProblem)
# ---------------------------------------------------------------------------


def ransac_rotation_only(
    u: torch.Tensor,  # (n_hyp, 2) uniform draws
    f_a: torch.Tensor,  # (N, 3) unit bearings in frame A
    f_b: torch.Tensor,  # (N, 3) unit bearings in frame B
    mask: torch.Tensor,  # (N,) bool
    focal: float = 460.0,
    threshold_px2: float = 9.0,
) -> RansacResult:
    """Finds R_AB maximizing inliers of f_a ≈ R_AB f_b. Model: quaternion."""
    idx = _sample_indices(u, mask)  # (H, 2)
    a, b = f_a[idx], f_b[idx]  # (H, 2, 3)
    # Wahba with 2 vector pairs: B = Σ f_a f_bᵀ; R = closest rotation
    B = a.transpose(-1, -2) @ b + 1e-9 * torch.eye(3, dtype=f_a.dtype, device=f_a.device)
    U, _, Vt = torch.linalg.svd(B)
    d = torch.sign(torch.linalg.det(U @ Vt))
    S = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    Rs = U @ S @ Vt  # (H, 3, 3) R_AB
    # score: angular error between f_a and R f_b, mapped to pixels
    rb = torch.einsum("hij,nj->hni", Rs, f_b)
    cos = torch.clamp(torch.sum(rb * f_a[None], dim=-1), -1.0, 1.0)
    err_px2 = (torch.arccos(cos) * focal) ** 2
    inl = (err_px2 < threshold_px2) & mask[None, :]
    counts = torch.sum(inl, dim=1)
    best = torch.argmax(counts)
    n_best = _pick(counts, best)
    return RansacResult(
        inliers=_pick(inl, best),
        num_inliers=n_best,
        model=so3.matrix_to_quat(_pick(Rs, best)),
        success=n_best >= 2,
    )


# ---------------------------------------------------------------------------
# relative pose: 8-point essential matrix (replaces Stewenius 5-pt)
# ---------------------------------------------------------------------------


def ransac_relative_pose(
    u: torch.Tensor,  # (n_hyp, 8) uniform draws
    f_a: torch.Tensor,  # (N, 3) unit bearings, frame A
    f_b: torch.Tensor,  # (N, 3) unit bearings, frame B
    mask: torch.Tensor,
    focal: float = 460.0,
    threshold_px2: float = 9.0,
) -> RansacResult:
    """Essential-matrix RANSAC: f_aᵀ E f_b = 0. Model: E (3,3) flattened,
    determined up to sign (the eigenvector's)."""
    idx = _sample_indices(u, mask)  # (H, 8)
    # normalized image coords (perspective division of bearings)
    xa = f_a[:, :2] / torch.clamp(f_a[:, 2:3], min=1e-6)
    xb = f_b[:, :2] / torch.clamp(f_b[:, 2:3], min=1e-6)
    pa, pb = xa[idx], xb[idx]  # (H, 8, 2)
    x1, y1 = pa[..., 0], pa[..., 1]
    x2, y2 = pb[..., 0], pb[..., 1]
    A = torch.stack(
        [x1 * x2, x1 * y2, x1, y1 * x2, y1 * y2, y1, x2, y2, torch.ones_like(x1)], dim=-1)  # (H, 8, 9)
    # null vector via eigendecomposition of AᵀA
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    E = V[..., :, 0].reshape(-1, 3, 3)
    # enforce essential structure
    U, _, Vt = torch.linalg.svd(E)
    D = torch.cat([torch.ones(2, dtype=E.dtype, device=E.device), torch.zeros(1, dtype=E.dtype, device=E.device)])
    Es = U @ torch.diag_embed(D.expand(E.shape[0], 3)) @ Vt  # (H, 3, 3)

    # Sampson distance in normalized coords -> pixel² via focal
    ha = torch.cat([xa, torch.ones_like(xa[:, :1])], dim=1)  # (N, 3)
    hb = torch.cat([xb, torch.ones_like(xb[:, :1])], dim=1)
    Exb = torch.einsum("hij,nj->hni", Es, hb)  # (H, N, 3)
    Eta = torch.einsum("hji,nj->hni", Es, ha)  # Eᵀ xa
    num = torch.einsum("ni,hni->hn", ha, Exb) ** 2
    den = Exb[..., 0] ** 2 + Exb[..., 1] ** 2 + Eta[..., 0] ** 2 + Eta[..., 1] ** 2
    sampson = num / torch.clamp(den, min=1e-12)
    err_px2 = sampson * focal * focal
    inl = (err_px2 < threshold_px2) & mask[None, :]
    counts = torch.sum(inl, dim=1)
    best = torch.argmax(counts)
    n_best = _pick(counts, best)
    return RansacResult(
        inliers=_pick(inl, best),
        num_inliers=n_best,
        model=_pick(Es, best).reshape(-1),
        success=n_best >= 8,
    )


# ---------------------------------------------------------------------------
# absolute pose: Kneip P3P (replaces OpenGV GP3P; planar-robust)
# ---------------------------------------------------------------------------


def _solve_quartic(a4, a3, a2, a1, a0):
    """Closed-form (Ferrari) roots of a4·x⁴ + a3·x³ + a2·x² + a1·x + a0.

    Branch-free elementwise complex arithmetic (complex128 for float64
    coefficients, complex64 otherwise, as the JAX package picks), batched
    over any leading dims. Returns (..., 4) complex roots; callers take real
    parts and let the scoring reject spurious ones. Integer powers are
    products, as JAX's integer_pow computes them."""
    ctype = torch.complex128 if a4.dtype == torch.float64 else torch.complex64
    a4s = torch.where(a4.abs() < 1e-12, torch.full_like(a4, 1e-12), a4)
    b = (a3 / a4s).to(ctype)
    c = (a2 / a4s).to(ctype)
    d = (a1 / a4s).to(ctype)
    e = (a0 / a4s).to(ctype)
    bb = b * b
    # depressed quartic y⁴ + p y² + q y + r with x = y − b/4
    p = c - 3.0 * bb / 8.0
    q = d - b * c / 2.0 + bb * b / 8.0
    r = e - b * d / 4.0 + bb * c / 16.0 - 3.0 * (bb * bb) / 256.0
    # resolvent cubic m³ + p m² + (p²/4 − r) m − q²/8 = 0
    c2 = p
    c1 = p * p / 4.0 - r
    c0 = -q * q / 8.0
    # Cardano
    d0 = c2 * c2 - 3.0 * c1
    d1 = 2.0 * (c2 * c2 * c2) - 9.0 * c2 * c1 + 27.0 * c0
    s = torch.sqrt(d1 * d1 - 4.0 * (d0 * d0 * d0))
    u = (d1 + s) / 2.0
    u = torch.where(u.abs() < 1e-30, (d1 - s) / 2.0, u)
    C = torch.exp(torch.log(u + (u == 0).to(ctype)) / 3.0)  # principal cube root
    C = torch.where(C.abs() < 1e-30, torch.full_like(C, 1e-30), C)
    m = -(c2 + C + d0 / C) / 3.0
    # avoid the m→0 singularity of the split (biquadratic case)
    m = torch.where(m.abs() < 1e-12, m + 1e-12, m)
    sq = torch.sqrt(2.0 * m)
    # (y² + p/2 + m)² = 2m (y − q/(4m))²  →  two quadratics
    t1 = p / 2.0 + m + q / (2.0 * sq)
    t2 = p / 2.0 + m - q / (2.0 * sq)
    r1 = torch.sqrt(sq * sq - 4.0 * t1)
    r2 = torch.sqrt(sq * sq - 4.0 * t2)
    ys = torch.stack(
        [(sq + r1) / 2.0, (sq - r1) / 2.0, (-sq + r2) / 2.0, (-sq - r2) / 2.0], dim=-1)
    return ys - (b / 4.0)[..., None]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def _p3p_kneip(P, f):
    """Kneip closed-form P3P ('A Novel Parametrization of the
    Perspective-Three-Point Problem', ICRA 2011), batched.

    P: (..., 3, 3) world points, f: (..., 3, 3) unit bearings in the camera
    frame. Returns (..., 4, 3, 4) camera-to-world candidates [R_WC | C] with
    X_W = R·X_C + C: up to 4 real solutions; spurious (complex-root) ones
    come out non-finite or score poorly."""

    def frame(f1, f2, f3):
        e1 = f1
        e3 = _unit(_cross(f1, f2))
        e2 = _cross(e3, e1)
        T = torch.stack([e1, e2, e3], dim=-2)  # rows
        return T, torch.einsum("...ij,...j->...i", T, f3)

    _, f3t0 = frame(f[..., 0, :], f[..., 1, :], f[..., 2, :])
    # θ must lie in (0, π): swap the first two correspondences when the
    # transformed third bearing has positive z (Kneip §III)
    swap = (f3t0[..., 2] > 0)[..., None]
    f1 = torch.where(swap, f[..., 1, :], f[..., 0, :])
    f2 = torch.where(swap, f[..., 0, :], f[..., 1, :])
    P1 = torch.where(swap, P[..., 1, :], P[..., 0, :])
    P2 = torch.where(swap, P[..., 0, :], P[..., 1, :])
    P3 = P[..., 2, :]
    T, f3t = frame(f1, f2, f[..., 2, :])

    n1 = P2 - P1
    d12 = torch.linalg.norm(n1, dim=-1)
    n1 = n1 / torch.clamp(d12, min=1e-12)[..., None]
    n3 = _unit(_cross(n1, P3 - P1))
    n2 = _cross(n3, n1)
    N = torch.stack([n1, n2, n3], dim=-2)  # rows
    P3n = torch.einsum("...ij,...j->...i", N, P3 - P1)
    p1, p2 = P3n[..., 0], P3n[..., 1]

    cos_beta = torch.sum(f1 * f2, dim=-1)
    bb = 1.0 / torch.clamp(1.0 - cos_beta * cos_beta, min=1e-12) - 1.0
    b_cot = torch.sign(cos_beta) * torch.sqrt(torch.clamp(bb, min=0.0))

    f3z = torch.where(f3t[..., 2].abs() < 1e-12, torch.full_like(f3t[..., 2], 1e-12), f3t[..., 2])
    g1 = f3t[..., 0] / f3z
    g2 = f3t[..., 1] / f3z

    # quartic in cos θ (Kneip eq. 11)
    p2_2, p1_2 = p2 * p2, p1 * p1
    p2_3, p2_4 = p2_2 * p2, p2_2 * p2_2
    g1_2, g2_2, d12_2, bc_2 = g1 * g1, g2 * g2, d12 * d12, b_cot * b_cot
    a4 = -g2_2 * p2_4 - g1_2 * p2_4 - p2_4
    a3 = (
        2.0 * p2_3 * d12 * b_cot
        + 2.0 * g2_2 * p2_3 * d12 * b_cot
        - 2.0 * g1 * g2 * p2_3 * d12
    )
    a2 = (
        -g2_2 * p1_2 * p2_2
        - g2_2 * p2_2 * d12_2 * bc_2
        - g2_2 * p2_2 * d12_2
        + g2_2 * p2_4
        + g1_2 * p2_4
        + 2.0 * p1 * p2_2 * d12
        + 2.0 * g1 * g2 * p1 * p2_2 * d12 * b_cot
        - g1_2 * p1_2 * p2_2
        + 2.0 * g2_2 * p1 * p2_2 * d12
        - p2_2 * d12_2 * bc_2
        - 2.0 * p1_2 * p2_2
    )
    a1 = (
        2.0 * p1_2 * p2 * d12 * b_cot
        + 2.0 * g1 * g2 * p2_3 * d12
        - 2.0 * g2_2 * p2_3 * d12 * b_cot
        - 2.0 * p1 * p2 * d12_2 * b_cot
    )
    a0 = (
        -2.0 * g1 * g2 * p1 * p2_2 * d12 * b_cot
        + g2_2 * p2_2 * d12_2
        + 2.0 * (p1_2 * p1) * d12
        - p1_2 * d12_2
        + g2_2 * p1_2 * p2_2
        - p1_2 * p1_2
        - 2.0 * g2_2 * p1 * p2_2 * d12
        + g1_2 * p1_2 * p2_2
        + g2_2 * p2_2 * d12_2 * bc_2
    )
    roots = _solve_quartic(a4, a3, a2, a1, a0)  # (..., 4) complex
    ct = torch.clamp(roots.real, -1.0, 1.0).to(P.dtype)  # (..., 4)

    # back substitution, one candidate per root
    ex = lambda x: x[..., None]  # noqa: E731  per-sample scalar against the 4 roots
    cot_a = (ex(g1 / g2 * p1) + ct * ex(p2) - ex(d12 * b_cot)) / (
        ex(g1 / g2) * ct * ex(p2) - ex(p1) + ex(d12))
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    sin_a = torch.sqrt(1.0 / (cot_a * cot_a + 1.0))
    cos_a = torch.sqrt(torch.clamp(1.0 - sin_a * sin_a, min=0.0))
    cos_a = torch.where(cot_a < 0, -cos_a, cos_a)
    amp = sin_a * ex(b_cot) + cos_a
    d = ex(d12)
    C_eta = torch.stack([d * cos_a * amp, d * sin_a * ct * amp, d * sin_a * st * amp], dim=-1)  # (..., 4, 3)
    Cw = P1[..., None, :] + torch.einsum("...ji,...kj->...ki", N, C_eta)  # P1 + Nᵀ C_eta
    zero = torch.zeros_like(ct)
    Q = torch.stack([
        torch.stack([-cos_a, -sin_a * ct, -sin_a * st], dim=-1),
        torch.stack([sin_a, -cos_a * ct, -cos_a * st], dim=-1),
        torch.stack([zero, -st, ct], dim=-1),
    ], dim=-2)  # (..., 4, 3, 3)
    R_WC = N.transpose(-1, -2)[..., None, :, :] @ Q.transpose(-1, -2) @ T[..., None, :, :]
    return torch.cat([R_WC, Cw[..., None]], dim=-1)  # (..., 4, 3, 4)


def _p3p_absolute_models(u, points_W, bearings, mask):
    """(n_hyp·4, 3, 4) central absolute-pose models [R_CW | t_C] from 3-point
    Kneip samples drawn (u: (n_hyp, 3)) from the masked correspondences."""
    idx = _sample_indices(u, mask)  # (H, 3)
    cands = _p3p_kneip(points_W[idx], bearings[idx])  # (H, 4, 3, 4)
    # camera-to-world [R_WC | C] -> world-to-camera [R_CW | t]
    R_CW = cands[..., :3].transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", R_CW, cands[..., 3])
    return torch.cat([R_CW, t[..., None]], dim=-1).reshape(-1, 3, 4)


# ---------------------------------------------------------------------------
# absolute pose: 6-point DLT (kept for study; coplanar-degenerate)
# ---------------------------------------------------------------------------


def _dlt_absolute_models(u, points_W, uv, mask) -> torch.Tensor:
    """(n_hyp, 3, 4) central absolute-pose models [R_CW | t_C] from 6-point
    DLT samples (u: (n_hyp, 6)) of the masked correspondences. The model
    depends on the sign of the eigenvector LAPACK returns, as in the JAX
    package."""
    idx = _sample_indices(u, mask)  # (H, 6)
    P = points_W[idx]  # (H, 6, 3)
    x = uv[idx]  # (H, 6, 2)
    # DLT rows for P = [p,1]: u = (r1·p+t1)/(r3·p+t3)
    Ph = torch.cat([P, torch.ones_like(P[..., :1])], dim=-1)  # (H, 6, 4)
    zeros = torch.zeros_like(Ph)
    rows_u = torch.cat([Ph, zeros, -x[..., :1] * Ph], dim=-1)  # (H, 6, 12)
    rows_v = torch.cat([zeros, Ph, -x[..., 1:2] * Ph], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (H, 12, 12)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    p = V[..., :, 0].reshape(-1, 3, 4)
    # orthogonalize the rotation part, fix scale/sign
    U, s, Vt = torch.linalg.svd(p[..., :3])
    d = torch.sign(torch.linalg.det(U @ Vt))
    S = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = U @ S @ Vt
    scale = torch.mean(s, dim=-1) * d
    t = p[..., 3] / torch.where(scale.abs() < 1e-12, torch.ones_like(scale), scale)[..., None]
    return torch.cat([R, t[..., None]], dim=-1)  # (H, 3, 4)


def ransac_absolute_pose(
    u: torch.Tensor,  # (n_hyp, 3) uniform draws
    points_W: torch.Tensor,  # (N, 3) landmark positions
    bearings_C: torch.Tensor,  # (N, 3) unit bearings in camera frame
    mask: torch.Tensor,
    focal: float = 460.0,
    threshold_px2: float = 9.0,
) -> RansacResult:
    """Camera-pose RANSAC from 3D-2D matches (ref runRansac3d2d,
    Frontend.cpp:575-642). Hypotheses from 3-point Kneip P3P. Model:
    flattened [R_CW | t_C] (3,4); x_C ∝ R_CW p_W + t."""
    uv = bearings_C[:, :2] / torch.clamp(bearings_C[:, 2:3], min=1e-6)  # (N, 2)
    Ms = _p3p_absolute_models(u, points_W, bearings_C, mask)
    finite = torch.all(torch.isfinite(Ms.reshape(Ms.shape[0], -1)), dim=-1)
    p_C = torch.einsum("hij,nj->hni", Ms[:, :, :3], points_W) + Ms[:, None, :, 3]
    z = p_C[..., 2]
    proj = p_C[..., :2] / torch.clamp(z.abs()[..., None], min=1e-6)
    err_px2 = torch.sum((proj - uv[None]) ** 2, dim=-1) * focal * focal
    inl = (err_px2 < threshold_px2) & (z > 0) & mask[None, :]
    counts = torch.where(finite, torch.sum(inl, dim=1), -1)
    best = torch.argmax(counts)
    n_best = _pick(counts, best)
    return RansacResult(
        inliers=_pick(inl, best),
        num_inliers=torch.clamp(n_best, min=0),
        model=_pick(Ms, best).reshape(-1),
        success=n_best >= 6,
    )


def ransac_absolute_rig(
    u: torch.Tensor,  # (C, n_hyp_per_cam, 3) uniform draws, one block a camera
    r_SC: torch.Tensor,  # (C, 3) camera-in-body translations
    q_SC: torch.Tensor,  # (C, 4) camera-in-body quaternions (xyzw)
    points_W: torch.Tensor,  # (C, K, 3) landmark positions per camera slot
    bearings_C: torch.Tensor,  # (C, K, 3) unit bearings in each camera frame
    mask: torch.Tensor,  # (C, K) candidate correspondences
    focal: torch.Tensor,  # (C,) focal lengths for the pixel threshold
    threshold_px2: float = 9.0,
) -> RansacResult:
    """Rig-level absolute-pose RANSAC pooling all cameras' correspondences
    (ref FrameNoncentralAbsoluteAdapter + GP3P runRansac3d2d,
    Frontend.cpp:575-642): hypotheses come from per-camera central 3-point
    Kneip P3P solves mapped through the known extrinsics to a body pose
    T_SW, and every hypothesis is scored against every camera's
    correspondences. Cameras with < 3 candidates contribute no hypotheses
    but still vote. Sync-free on CUDA.

    Model: flattened [R_SW | t_SW] (3,4); p_S = R_SW p_W + t_SW. Returns
    inliers with shape (C, K)."""
    C, H = u.shape[0], u.shape[1]
    C_SC = so3.quat_to_matrix(q_SC)  # (C, 3, 3)
    uv = bearings_C[..., :2] / torch.clamp(bearings_C[..., 2:3], min=1e-6)
    Ms = torch.stack([_p3p_absolute_models(u[c], points_W[c], bearings_C[c], mask[c])
                      for c in range(C)])  # (C, H·4, 3, 4)
    # T_SW = T_SC ∘ T_CW:  R_SW = C_SC·R_CW,  t_SW = C_SC·t_C + r_SC
    R_SW = torch.einsum("cab,chbj->chaj", C_SC, Ms[..., :3])
    t_SW = torch.einsum("cab,chb->cha", C_SC, Ms[..., 3]) + r_SC[:, None, :]
    valid_c = torch.sum(mask, dim=1) >= 3  # (C,)
    M = torch.cat([R_SW, t_SW[..., None]], dim=-1).reshape(-1, 3, 4)  # (C·H·4, 3, 4)
    hyp_valid = valid_c.repeat_interleave(H * 4)
    hyp_valid = hyp_valid & torch.all(torch.isfinite(M.reshape(M.shape[0], -1)), dim=-1)

    # score every hypothesis against every camera's correspondences
    p_S = torch.einsum("hij,ckj->hcki", M[:, :, :3], points_W) + M[:, None, None, :, 3]  # (H', C, K, 3)
    p_C = torch.einsum("cab,hckb->hcka", C_SC.transpose(1, 2), p_S - r_SC[None, :, None, :])
    z = p_C[..., 2]
    proj = p_C[..., :2] / torch.clamp(z.abs()[..., None], min=1e-6)
    err_px2 = torch.sum((proj - uv[None]) ** 2, dim=-1) * (focal[None, :, None] ** 2)
    inl = (err_px2 < threshold_px2) & (z > 0) & mask[None]
    counts = torch.where(hyp_valid, torch.sum(inl, dim=(1, 2)), -1)
    best = torch.argmax(counts)
    n_best = _pick(counts, best)
    return RansacResult(
        inliers=_pick(inl, best),
        num_inliers=torch.clamp(n_best, min=0),
        model=_pick(M, best).reshape(-1),
        success=n_best >= 6,
    )


def decompose_essential(
    E: torch.Tensor,  # (3, 3)
    f_a: torch.Tensor,  # (N, 3) bearings frame A
    f_b: torch.Tensor,  # (N, 3) bearings frame B
    mask: torch.Tensor,  # (N,) inliers to vote with
):
    """E -> (R_AB, t_AB unit) by cheirality voting over the four candidates.
    Convention: f_a ≈ R_AB f_b·λ + t·μ, epipolar constraint f_aᵀ [t]x R f_b
    = 0 with E = [t]x R. The candidates are the same set whatever signs
    LAPACK gives the singular vectors."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype).to(E.device)
    R1 = U @ W @ Vt * d
    R2 = U @ W.T @ Vt * d
    t1 = U[:, 2]
    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t1, -t1, t1, -t1])
    # triangulate by midpoint along each pair; count points with positive
    # depth in both views: solve [f_a, -rb] [la, lb]ᵀ = t per pair
    rb = torch.einsum("cij,nj->cni", cands_R, f_b)  # (4, N, 3)
    a11 = torch.sum(f_a * f_a, dim=1)[None]
    a12 = -torch.sum(f_a[None] * rb, dim=2)
    a22 = torch.sum(rb * rb, dim=2)
    b1 = torch.einsum("ni,ci->cn", f_a, cands_t)
    b2 = -torch.sum(rb * cands_t[:, None, :], dim=2)
    det = a11 * a22 - a12 * a12
    safe = torch.where(det.abs() < 1e-12, torch.ones_like(det), det)
    la = (a22 * b1 - a12 * b2) / safe
    lb = (-a12 * b1 + a11 * b2) / safe
    votes = torch.sum((la > 0) & (lb > 0) & mask[None], dim=1)
    best = torch.argmax(votes)
    return _pick(cands_R, best), _pick(cands_t, best)
