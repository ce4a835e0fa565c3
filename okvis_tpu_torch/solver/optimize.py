"""Sliding-window BA: Schur-complement landmark elimination and the LM or
dogleg trust-region loop (port of okvis_tpu.solver.optimize).

The landmark blocks are eliminated with batched closed-form 3x3 inverses;
the reduced dense system (D = S*15 + C*6) is Jacobi-scaled and solved by a
Newton-Schulz inverse (default) or Cholesky. The trust-region loop runs a
fixed cfg.max_iterations iterations as a Python loop whose accept/reject is
a ``torch.where`` on device values, the carry of the JAX package's
``lax.scan``: no iteration reads a value back to the host, so the whole
optimize can run under ``torch.cuda.set_sync_debug_mode("error")`` and is a
candidate for CUDA-graph capture.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from ..imu.preintegration import ImuParams
from ..kinematics import se3
from ..kinematics.se3 import SE3
from ..linalg import cholesky
from .assemble import NormalEqs, evaluate
from .structure import BaProblem, WindowConfig, WindowStates


class SolveDiagnostics(NamedTuple):
    cost_history: torch.Tensor  # (iters,)
    accepted: torch.Tensor  # (iters,) bool
    final_cost: torch.Tensor
    final_lambda: torch.Tensor
    # (L,) landmark quality sqrt(lmin/lmax) of the 3x3 landmark Hessians at
    # the final iterate
    landmark_quality: torch.Tensor = None


def _select(accept: torch.Tensor, a: NamedTuple, b: NamedTuple) -> NamedTuple:
    """Field by field: a where accept, else b (accept is a 0-d bool tensor)."""
    return type(a)(*(torch.where(accept, x, y) for x, y in zip(a, b)))


def _sym3x3_eig_extremes(A: torch.Tensor):
    """(lmin, lmax) of batched symmetric 3x3 matrices, closed form
    (trigonometric method), elementwise only."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    ps = torch.where(p > 0.0, p, torch.ones_like(p))
    b00, b11, b22 = (a00 - q) / ps, (a11 - q) / ps, (a22 - q) / ps
    b01, b02, b12 = a01 / ps, a02 / ps, a12 / ps
    detB = (b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    phi = torch.arccos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    # p == 0: A = q I, all eigenvalues equal q
    return torch.where(p > 0.0, lam_min, q), torch.where(p > 0.0, lam_max, q)


def _landmark_quality(H_ll: torch.Tensor) -> torch.Tensor:
    lam_min, lam_max = _sym3x3_eig_extremes(H_ll)
    quality = torch.sqrt(torch.clamp(lam_min, min=0.0)) / torch.sqrt(torch.clamp(lam_max, min=1e-300))
    return torch.where(lam_min < 1e-12, torch.zeros_like(quality), quality)


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse by the adjugate; singular blocks
    (|det| < 1e-20) give zeros."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00, A01, A02 = e * i - f * h, c * h - b * i, b * f - c * e
    A10, A11, A12 = f * g - d * i, a * i - c * g, c * d - a * f
    A20, A21, A22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A00 + b * A10 + c * A20
    singular = (det.abs() < 1e-20)[..., None, None]
    adj = torch.stack([torch.stack([A00, A01, A02], -1), torch.stack([A10, A11, A12], -1),
                       torch.stack([A20, A21, A22], -1)], -2)
    inv = adj / torch.where(singular, torch.ones_like(det[..., None, None]), det[..., None, None])
    return torch.where(singular, torch.zeros_like(inv), inv)


def _spd_solve_newton(Hs: torch.Tensor, rhs: torch.Tensor, iters: int = 46) -> torch.Tensor:
    """Solve the Jacobi-scaled SPD system by a Newton-Schulz inverse,
    X <- X (2I - Hs X) from X0 = I / tr(Hs): two matmuls a doubling.

    With X0 = I/tr(Hs) the eigenvalues of I - X0 Hs lie in [0, 1) for any
    SPD Hs, so the iteration converges monotonically; after k doublings the
    worst error factor is (1 - lmin/tr)^(2^k). The callers' +1e-10 I floor
    on a unit diagonal caps the conditioning, and 46 doublings (the JAX
    package's count) converge for conditioning up to about 1e13."""
    eye = torch.eye(Hs.shape[-1], dtype=Hs.dtype, device=Hs.device)
    two_eye = 2.0 * eye
    X = eye * (1.0 / torch.trace(Hs))
    for _ in range(iters):
        X = X @ torch.addmm(two_eye, Hs, X, alpha=-1.0)
    return X @ rhs


def _chol_solve(Hs: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """Cholesky solve; NaN where Hs is not positive definite (linalg.py)."""
    L = cholesky(Hs)
    y = torch.linalg.solve_triangular(L, bs[:, None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]


def solve_scaled_spd(Hs: torch.Tensor, bs: torch.Tensor, solver: str) -> torch.Tensor:
    """Solve the Jacobi-scaled SPD system with the configured dense solver
    ('newton' by default, or 'cholesky')."""
    if solver == "cholesky":
        return _chol_solve(Hs, bs)
    return _spd_solve_newton(Hs, bs)


def dense_dim_mask(cfg: WindowConfig, state_mask: torch.Tensor, sb_mask: torch.Tensor = None
                   ) -> torch.Tensor:
    """(D,) bool: which dense dims are free variables. Pose dims follow
    state_mask; speed/bias dims also need sb_mask; the shared extrinsics
    block is free when cfg.estimate_extrinsics."""
    S, C = cfg.num_states, cfg.num_cameras
    sm = state_mask[:, None].expand(S, 15)
    if sb_mask is not None:
        sm = torch.cat([sm[:, :6], sm[:, 6:] & sb_mask[:, None]], dim=1)
    em = torch.full((C * 6,), cfg.estimate_extrinsics, dtype=torch.bool, device=state_mask.device)
    return torch.cat([sm.reshape(S * 15), em])


def solve_normal_eqs(cfg: WindowConfig, eqs: NormalEqs, state_mask: torch.Tensor,
                     lm_mask: torch.Tensor, lam: torch.Tensor, sb_mask: torch.Tensor = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped Schur solve: (delta_dense (D,), delta_landmarks (L, 3))."""
    dtype, device = eqs.H_dd.dtype, eqs.H_dd.device
    D = cfg.dense_dim
    dim_mask = dense_dim_mask(cfg, state_mask, sb_mask)

    # LM damping: H + lam diag(H) (+ floor) on both blocks
    H_dd = eqs.H_dd + torch.diag(lam * torch.diagonal(eqs.H_dd) + 1e-12)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    H_ll = eqs.H_ll + lam * (eqs.H_ll * eye3) + 1e-12 * eye3

    # inactive landmarks contribute nothing and get a zero update
    Hl_inv = _inv3x3(H_ll) * lm_mask.to(dtype)[:, None, None]

    # Schur complement onto the dense block
    WH = eqs.W @ Hl_inv  # (L, D, 3)
    H_red = H_dd - torch.einsum("ldb,leb->de", WH, eqs.W)
    b_red = eqs.b_d - torch.einsum("ldb,lb->d", WH, eqs.b_l)

    # fixed or inactive dense dims: identity rows/cols, zero right-hand side
    mf = dim_mask.to(dtype)
    H_red = H_red * mf[:, None] * mf[None, :] + torch.diag(1.0 - mf)
    b_red = b_red * mf

    # Jacobi preconditioning keeps the dense solve well scaled in float32
    s = torch.sqrt(torch.clamp(torch.diagonal(H_red), min=1e-12))
    Hs = H_red / (s[:, None] * s[None, :]) + 1e-10 * torch.eye(D, dtype=dtype, device=device)
    delta_d = solve_scaled_spd(Hs, b_red / s, cfg.dense_solver) / s * mf

    # back-substitute the landmarks
    rhs_l = eqs.b_l - torch.einsum("ldk,d->lk", eqs.W, delta_d)
    delta_l = (Hl_inv @ rhs_l[..., None])[..., 0]
    return delta_d, delta_l


def apply_update(cfg: WindowConfig, states: WindowStates, delta_d: torch.Tensor, delta_l: torch.Tensor,
                 state_mask: torch.Tensor, lm_mask: torch.Tensor) -> WindowStates:
    S, C = cfg.num_states, cfg.num_cameras
    d_states = delta_d[: S * 15].reshape(S, 15)
    sm = state_mask.to(delta_d.dtype)[:, None]
    new_pose = se3.oplus(SE3(r=states.r_WS, q=states.q_WS), d_states[:, :6] * sm)
    new_ext = se3.oplus(SE3(r=states.r_SC, q=states.q_SC), delta_d[S * 15: S * 15 + C * 6].reshape(C, 6))
    lm_f = lm_mask.to(delta_d.dtype)[:, None]
    return WindowStates(
        r_WS=new_pose.r,
        q_WS=new_pose.q,
        speed_and_bias=states.speed_and_bias + d_states[:, 6:15] * sm,
        r_SC=new_ext.r,
        q_SC=new_ext.q,
        hp_W=torch.cat([states.hp_W[:, :3] + delta_l * lm_f, states.hp_W[:, 3:]], dim=1),
    )


def _system_quadratic(eqs: NormalEqs, delta_d, delta_l, lm_mask):
    """b^T p and p^T H p for the full (dense + landmark) system: the dogleg's
    predicted-decrease model."""
    dl = delta_l * lm_mask.to(delta_d.dtype)[:, None]
    btp = torch.dot(eqs.b_d, delta_d) + torch.sum(eqs.b_l * dl)
    Wdl = torch.einsum("ldk,lk->d", eqs.W, dl)
    pHp = (torch.dot(delta_d, eqs.H_dd @ delta_d + Wdl) + torch.dot(Wdl, delta_d)
           + torch.einsum("la,lab,lb->", dl, eqs.H_ll, dl))
    return btp, pHp


def _trust0(value, default: float, like: torch.Tensor) -> torch.Tensor:
    if value is None:
        return torch.full((), default, dtype=like.dtype, device=like.device)
    return value.to(like.dtype) if isinstance(value, torch.Tensor) else torch.full(
        (), float(value), dtype=like.dtype, device=like.device)


def _sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x)


def optimize_window_dogleg(cfg: WindowConfig, imu_params: ImuParams, intrinsics: List[torch.Tensor],
                           problem: BaProblem, trust0=None) -> Tuple[WindowStates, SolveDiagnostics]:
    """Powell dogleg trust-region loop (the reference's Ceres DOGLEG mode):
    blend the Gauss-Newton step with the Cauchy step inside a trust radius;
    rho-based radius update. `trust0` warm-starts the radius."""
    states = problem.states
    eqs = evaluate(cfg, imu_params, intrinsics, problem, states)
    radius = _trust0(trust0, cfg.init_radius, states.r_WS)
    zero_lam = torch.full((), 1e-10, dtype=states.r_WS.dtype, device=states.r_WS.device)
    mf = dense_dim_mask(cfg, problem.state_mask, problem.sb_mask).to(states.r_WS.dtype)
    lm_f = problem.lm_mask.to(states.r_WS.dtype)[:, None]
    hist, acc = [], []
    for _ in range(cfg.max_iterations):
        cost = eqs.cost
        gn_d, gn_l = solve_normal_eqs(cfg, eqs, problem.state_mask, problem.lm_mask, zero_lam,
                                      problem.sb_mask)
        # Cauchy point along the gradient direction b, masked to the free dims
        b_d, b_l = eqs.b_d * mf, eqs.b_l * lm_f
        _, bHb = _system_quadratic(eqs, b_d, b_l, problem.lm_mask)
        alpha = (_sq(b_d) + _sq(b_l)) / torch.clamp(bHb, min=1e-30)
        sd_d, sd_l = alpha * b_d, alpha * b_l
        gn_norm = torch.sqrt(_sq(gn_d) + _sq(gn_l) + 1e-300)
        sd_norm = torch.sqrt(_sq(sd_d) + _sq(sd_l) + 1e-300)

        # blend coefficient beta along (gn - sd) with |sd + beta d| = radius
        dd_d, dd_l = gn_d - sd_d, gn_l - sd_l
        a_ = _sq(dd_d) + _sq(dd_l)
        b_ = 2.0 * (torch.dot(sd_d, dd_d) + torch.sum(sd_l * dd_l))
        c_ = sd_norm * sd_norm - radius * radius
        disc = torch.sqrt(torch.clamp(b_ * b_ - 4 * a_ * c_, min=0.0))
        beta = torch.clamp((-b_ + disc) / torch.clamp(2 * a_, min=1e-30), 0.0, 1.0)

        use_gn = gn_norm <= radius
        sd_over = sd_norm >= radius
        scale_sd = radius / sd_norm
        p_d = torch.where(use_gn, gn_d, torch.where(sd_over, scale_sd * sd_d, sd_d + beta * dd_d))
        p_l = torch.where(use_gn, gn_l, torch.where(sd_over, scale_sd * sd_l, sd_l + beta * dd_l))

        cand = apply_update(cfg, states, p_d, p_l, problem.state_mask, problem.lm_mask)
        eqs_cand = evaluate(cfg, imu_params, intrinsics, problem, cand)
        btp, pHp = _system_quadratic(eqs, p_d, p_l, problem.lm_mask)
        predicted = btp - 0.5 * pHp
        rho = (cost - eqs_cand.cost) / torch.clamp(predicted, min=1e-30)
        accept = (eqs_cand.cost < cost) & (predicted > 0)
        states = _select(accept, cand, states)
        eqs = _select(accept, eqs_cand, eqs)
        p_norm = torch.sqrt(_sq(p_d) + _sq(p_l) + 1e-300)
        radius = torch.where(rho > 0.75, torch.maximum(radius, 3.0 * p_norm),
                             torch.where(rho < 0.25, 0.25 * radius, radius))
        radius = torch.clamp(torch.where(accept, radius, 0.25 * radius), 1e-8, 1e12)
        hist.append(eqs.cost)
        acc.append(accept)
    return states, SolveDiagnostics(
        cost_history=torch.stack(hist), accepted=torch.stack(acc), final_cost=eqs.cost,
        final_lambda=radius, landmark_quality=_landmark_quality(eqs.H_ll))


def optimize_window(cfg: WindowConfig, imu_params: ImuParams, intrinsics: List[torch.Tensor],
                    problem: BaProblem, trust0=None) -> Tuple[WindowStates, SolveDiagnostics]:
    """Trust-region loop over the whole window: LM (default) or dogleg
    (cfg.algorithm). A fixed cfg.max_iterations iterations; a rejected step
    raises the damping and keeps the iterate. `trust0` warm-starts the
    damping (LM lambda or dogleg radius) for a continuation.

    The normal equations of the current iterate ride the carry: each
    iteration evaluates the factors once, at the candidate."""
    if cfg.algorithm == "dogleg":
        return optimize_window_dogleg(cfg, imu_params, intrinsics, problem, trust0)
    states = problem.states
    eqs = evaluate(cfg, imu_params, intrinsics, problem, states)
    lam = _trust0(trust0, cfg.init_lambda, states.r_WS)
    hist, acc = [], []
    for _ in range(cfg.max_iterations):
        delta_d, delta_l = solve_normal_eqs(cfg, eqs, problem.state_mask, problem.lm_mask, lam,
                                            problem.sb_mask)
        cand = apply_update(cfg, states, delta_d, delta_l, problem.state_mask, problem.lm_mask)
        eqs_cand = evaluate(cfg, imu_params, intrinsics, problem, cand)
        accept = eqs_cand.cost < eqs.cost
        states = _select(accept, cand, states)
        eqs = _select(accept, eqs_cand, eqs)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-10, 1e8)
        hist.append(eqs.cost)
        acc.append(accept)
    return states, SolveDiagnostics(
        cost_history=torch.stack(hist), accepted=torch.stack(acc), final_cost=eqs.cost,
        final_lambda=lam, landmark_quality=_landmark_quality(eqs.H_ll))
