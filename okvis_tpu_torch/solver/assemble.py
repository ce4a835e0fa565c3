"""Batched factor evaluation and normal-equation assembly (port of
okvis_tpu.solver.assemble).

All reprojection factors evaluate in one batched pass per camera (selected
by cam_idx), the IMU links and priors in one batched pass each. Where the
JAX package assembles with one-hot matmuls (the TPU's way to avoid
scatters; the observation one-hot alone is O x 12 x D, 14.5 MB at the
estimator's full window in float32), the port adds each factor's small
J^T J and J^T r blocks into H and b with ``index_add``, and never builds a
one-hot.

Gauss-Newton convention: cost = sum rho(|r|^2) / 2; H delta = b with
H = sum J^T J (robustly weighted), b = -sum J^T r. The Cauchy robustifier
follows Ceres' corrector: residual and Jacobian scale by sqrt(rho').
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..factors.imu_factor import imu_error
from ..factors.priors import pose_error, speed_and_bias_error
from ..factors.reprojection import reprojection_error
from ..imu.preintegration import ImuParams
from ..kinematics import se3
from ..kinematics.se3 import SE3
from .structure import BaProblem, MargPrior, Observations, WindowConfig, WindowStates


class NormalEqs(NamedTuple):
    H_dd: torch.Tensor  # (D, D) dense (poses + speed/bias + extrinsics)
    b_d: torch.Tensor  # (D,)
    H_ll: torch.Tensor  # (L, 3, 3) landmark blocks
    b_l: torch.Tensor  # (L, 3)
    W: torch.Tensor  # (L, D, 3) dense-landmark coupling
    cost: torch.Tensor  # () total cost


def _cauchy_weight(cfg: WindowConfig, sq_norm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cost, sqrt(rho')) for the Cauchy loss rho(s) = a^2 log(1 + s/a^2)."""
    a2 = cfg.cauchy_scale * cfg.cauchy_scale
    cost = 0.5 * a2 * torch.log1p(sq_norm / a2)
    w = 1.0 / (1.0 + sq_norm / a2)
    return cost, torch.sqrt(w)


def marg_delta_chi(cfg: WindowConfig, states: WindowStates, marg: MargPrior) -> torch.Tensor:
    """dchi = current [-] first-estimate point over the dense vector (D,)."""
    d_pose = se3.minus(SE3(r=marg.r_WS_lin, q=marg.q_WS_lin), SE3(r=states.r_WS, q=states.q_WS))
    d_sb = states.speed_and_bias - marg.sb_lin
    d_ext = se3.minus(SE3(r=marg.r_SC_lin, q=marg.q_SC_lin), SE3(r=states.r_SC, q=states.q_SC))
    return torch.cat([torch.cat([d_pose, d_sb], dim=-1).reshape(-1), d_ext.reshape(-1)])


def add_factor_blocks(H: torch.Tensor, b: torch.Tensor, J: torch.Tensor, res: torch.Tensor,
                      cols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """H[cols_i, cols_j] += sum_rows J_i J_j and b[cols] -= J^T res for a
    batch of factors: J (N, m, k), res (N, m), cols (N, k) dense columns.
    The scatter form of the JAX package's one-hot products (repeated columns
    add up in both)."""
    D = H.shape[0]
    JtJ = J.mT @ J  # (N, k, k)
    Jtr = (J.mT @ res[..., None])[..., 0]  # (N, k)
    cells = (cols[:, :, None] * D + cols[:, None, :]).reshape(-1)
    H = H.reshape(-1).index_add(0, cells, JtJ.reshape(-1)).reshape(D, D)
    return H, b.index_add(0, cols.reshape(-1), -Jtr.reshape(-1))


def evaluate_reprojection(cfg: WindowConfig, intrinsics: List[torch.Tensor], obs: Observations,
                          states: WindowStates):
    """Reprojection-factor part of the normal equations:
    (H_dd, b_d, H_ll, b_l, W, cost)."""
    dtype, device = states.r_WS.dtype, states.r_WS.device
    S, C, D = cfg.num_states, cfg.num_cameras, cfg.dense_dim
    L, O = states.hp_W.shape[0], obs.mask.shape[0]

    T_WS_o = SE3(r=states.r_WS[obs.state_idx], q=states.q_WS[obs.state_idx])
    hp_o = states.hp_W[obs.lm_idx]
    # each camera evaluates every observation; its own rows are selected
    res = torch.zeros((O, 2), dtype=dtype, device=device)
    J_pose = torch.zeros((O, 2, 6), dtype=dtype, device=device)
    J_ext = torch.zeros((O, 2, 6), dtype=dtype, device=device)
    J_hp = torch.zeros((O, 2, 3), dtype=dtype, device=device)
    for c in range(C):
        r_c, J_c, _valid = reprojection_error(
            cfg.camera_specs[c], intrinsics[c], obs.keypoint, obs.sqrt_info, T_WS_o, hp_o,
            SE3(r=states.r_SC[c], q=states.q_SC[c]))
        sel = (obs.cam_idx == c)[:, None]
        res = torch.where(sel, r_c, res)
        J_pose = torch.where(sel[..., None], J_c.J_pose, J_pose)
        J_ext = torch.where(sel[..., None], J_c.J_ext, J_ext)
        J_hp = torch.where(sel[..., None], J_c.J_hp, J_hp)

    m = obs.mask[:, None].to(dtype)
    res = res * m
    # robust (Cauchy) weighting: Ceres' corrector scales by sqrt(rho')
    rep_cost, w_r = _cauchy_weight(cfg, torch.sum(res * res, dim=-1))
    cost = torch.sum(rep_cost * obs.mask)
    res = res * w_r[:, None]
    scale = w_r[:, None, None] * m[..., None]
    J_pose = J_pose * scale
    J_hp = J_hp * scale
    J_ext = J_ext * scale if cfg.estimate_extrinsics else torch.zeros_like(J_ext)

    # dense 12-column block per observation: [pose(6) | extrinsics(6)]
    col6 = torch.arange(6, dtype=torch.int64, device=device)
    cols = torch.cat([obs.state_idx[:, None] * 15 + col6, S * 15 + obs.cam_idx[:, None] * 6 + col6], dim=1)
    J12 = torch.cat([J_pose, J_ext], dim=-1)  # (O, 2, 12)
    H_dd, b_d = add_factor_blocks(torch.zeros((D, D), dtype=dtype, device=device),
                                  torch.zeros((D,), dtype=dtype, device=device), J12, res, cols)

    # landmark blocks and the dense-landmark coupling, added per landmark slot
    lm = obs.lm_idx.to(torch.int64)
    H_ll = torch.zeros((L, 3, 3), dtype=dtype, device=device).index_add(0, lm, J_hp.mT @ J_hp)
    b_l = torch.zeros((L, 3), dtype=dtype, device=device).index_add(0, lm, -(J_hp.mT @ res[..., None])[..., 0])
    WD = J12.mT @ J_hp  # (O, 12, 3)
    W = torch.zeros((L * D, 3), dtype=dtype, device=device).index_add(
        0, (lm[:, None] * D + cols).reshape(-1), WD.reshape(-1, 3)).reshape(L, D, 3)
    return H_dd, b_d, H_ll, b_l, W, cost


def evaluate_dense_factors(cfg: WindowConfig, imu_params: ImuParams, problem: BaProblem,
                           states: WindowStates):
    """IMU links + priors + marginal prior -> (H_dd, b_d, cost)."""
    dtype, device = states.r_WS.dtype, states.r_WS.device
    D = cfg.dense_dim
    H_dd = torch.zeros((D, D), dtype=dtype, device=device)
    b_d = torch.zeros((D,), dtype=dtype, device=device)
    col15 = torch.arange(15, dtype=torch.int64, device=device)

    # IMU link factors: 30 dense columns pose_a(6) sb_a(9) pose_b(6) sb_b(9)
    links = problem.imu_links
    ia, ib = links.idx_a, links.idx_b
    imu_res, imu_J = imu_error(
        imu_params, links.pre, SE3(r=states.r_WS[ia], q=states.q_WS[ia]), states.speed_and_bias[ia],
        SE3(r=states.r_WS[ib], q=states.q_WS[ib]), states.speed_and_bias[ib])
    lmf = links.mask.to(dtype)
    imu_res = imu_res * lmf[:, None]
    cost = 0.5 * torch.sum(imu_res * imu_res)
    J30 = torch.cat([imu_J.J_pose0, imu_J.J_sb0, imu_J.J_pose1, imu_J.J_sb1], dim=-1) * lmf[:, None, None]
    cols = torch.cat([ia[:, None] * 15 + col15, ib[:, None] * 15 + col15], dim=1)
    H_dd, b_d = add_factor_blocks(H_dd, b_d, J30, imu_res, cols)

    # pose priors
    pp = problem.pose_priors
    pp_res, pp_J = pose_error(SE3(r=pp.r_meas, q=pp.q_meas), pp.sqrt_info,
                              SE3(r=states.r_WS[pp.state_idx], q=states.q_WS[pp.state_idx]))
    ppm = pp.mask.to(dtype)
    pp_res = pp_res * ppm[:, None]
    cost = cost + 0.5 * torch.sum(pp_res * pp_res)
    H_dd, b_d = add_factor_blocks(H_dd, b_d, pp_J * ppm[:, None, None], pp_res,
                                  pp.state_idx[:, None] * 15 + col15[:6])

    # speed/bias priors
    sp = problem.sb_priors
    sp_res, sp_J = speed_and_bias_error(sp.sb_meas, sp.sqrt_info, states.speed_and_bias[sp.state_idx])
    spm = sp.mask.to(dtype)
    sp_res = sp_res * spm[:, None]
    cost = cost + 0.5 * torch.sum(sp_res * sp_res)
    H_dd, b_d = add_factor_blocks(H_dd, b_d, sp_J * spm[:, None, None], sp_res,
                                  sp.state_idx[:, None] * 15 + col15[6:])

    # marginalization prior
    marg = problem.marg
    dchi = marg_delta_chi(cfg, states, marg)
    mv = marg.valid.to(dtype)
    H_dd = H_dd + mv * marg.H
    b_d = b_d + mv * (marg.b0 - marg.H @ dchi)
    cost = cost + mv * 0.5 * (marg.c0 - 2.0 * torch.dot(marg.b0, dchi) + dchi @ marg.H @ dchi)
    return H_dd, b_d, cost


def evaluate(cfg: WindowConfig, imu_params: ImuParams, intrinsics: List[torch.Tensor],
             problem: BaProblem, states: WindowStates) -> NormalEqs:
    """Evaluate every factor at `states` and assemble the normal equations."""
    H_obs, b_obs, H_ll, b_l, W, cost_obs = evaluate_reprojection(cfg, intrinsics, problem.obs, states)
    H_dense, b_dense, cost_dense = evaluate_dense_factors(cfg, imu_params, problem, states)
    return NormalEqs(H_dd=H_obs + H_dense, b_d=b_obs + b_dense, H_ll=H_ll, b_l=b_l, W=W,
                     cost=cost_obs + cost_dense)
