"""Batched factor evaluation and normal-equation assembly (port of
okvis_tpu.solver.assemble).

All reprojection factors evaluate in one batched pass per camera (selected
by cam_idx), the IMU links and priors in one batched pass each. The
assembly gives the same bits on every run: no float sum goes through an
atomic scatter. Each factor's Jacobian is laid out as dense rows over the D
dense columns, and H = R^T R, b = -R^T r is one matrix product; the landmark
blocks H_ll, b_l and the coupling W are grouped by landmark slot with a
one-hot (O, L) product, as the JAX package does. The observations' rows are
written with a scatter whose indices never repeat (the pose and extrinsics
columns of one observation are distinct), so the (O, 12, D) observation
one-hot of the JAX package (14.5 MB at the estimator's full window in
float32) is never built; the dense factors' few rows use the one-hot
product, so repeated columns add up as in JAX.

Gauss-Newton convention: cost = sum rho(|r|^2) / 2; H delta = b with
H = sum J^T J (robustly weighted), b = -sum J^T r. The Cauchy robustifier
follows Ceres' corrector: residual and Jacobian scale by sqrt(rho').
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..factors.imu_factor import imu_error
from ..factors.priors import pose_error, relative_pose_error, speed_and_bias_error
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
    parts = [torch.cat([d_pose, d_sb], dim=-1).reshape(-1), d_ext.reshape(-1)]
    if cfg.extrinsics_per_state:
        d_ps = se3.minus(SE3(r=marg.r_SC_t_lin.reshape(-1, 3), q=marg.q_SC_t_lin.reshape(-1, 4)),
                         SE3(r=states.r_SC_t.reshape(-1, 3), q=states.q_SC_t.reshape(-1, 4)))
        parts.append(d_ps.reshape(-1))  # (S*C*6,)
    return torch.cat(parts)


def factor_rows(J: torch.Tensor, cols: torch.Tensor, D: int) -> torch.Tensor:
    """Dense Jacobian rows (N, m, D) of N factors: J (N, m, k) at dense
    columns cols (N, k), by a one-hot product (repeated columns add up)."""
    return J @ torch.nn.functional.one_hot(cols.to(torch.int64), D).to(J.dtype)


def normal_eqs_of_rows(rows: torch.Tensor, res: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """H = R^T R and b = -R^T r for the factors' dense rows (N, m, D) and
    residuals (N, m): two matrix products, summed in a fixed order."""
    R = rows.reshape(-1, rows.shape[-1])
    return R.mT @ R, -(R.mT @ res.reshape(-1))


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
        if cfg.extrinsics_per_state:
            # each observation sees its own state's T_SC block
            T_SC = SE3(r=states.r_SC_t[obs.state_idx, c], q=states.q_SC_t[obs.state_idx, c])
        else:
            T_SC = SE3(r=states.r_SC[c], q=states.q_SC[c])
        r_c, J_c, _valid = reprojection_error(
            cfg.camera_specs[c], intrinsics[c], obs.keypoint, obs.sqrt_info, T_WS_o, hp_o, T_SC)
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
    J_ext = (J_ext * scale if cfg.estimate_extrinsics or cfg.extrinsics_per_state
             else torch.zeros_like(J_ext))

    # dense 12-column block per observation: [pose(6) | extrinsics(6)],
    # scattered into its row of D columns (the 12 columns never repeat); the
    # extrinsics columns are the shared block's or the observation's
    # per-state block's
    col6 = torch.arange(6, dtype=torch.int64, device=device)
    if cfg.extrinsics_per_state:
        ext0 = S * 15 + C * 6 + (obs.state_idx * C + obs.cam_idx).to(torch.int64) * 6
    else:
        ext0 = S * 15 + obs.cam_idx.to(torch.int64) * 6
    cols = torch.cat([obs.state_idx[:, None] * 15 + col6, ext0[:, None] + col6], dim=1)
    J12 = torch.cat([J_pose, J_ext], dim=-1)  # (O, 2, 12)
    # out of place: the in-place scatter_ has no torch.func.vmap batching rule
    J_full = J12.new_zeros((O, 2, D)).scatter(2, cols[:, None, :].expand(O, 2, 12), J12)
    H_dd, b_d = normal_eqs_of_rows(J_full, res)

    # landmark blocks and the dense-landmark coupling, grouped by landmark
    # slot with one one-hot product
    M = (obs.lm_idx.to(torch.int64)[:, None] == torch.arange(L, device=device)).to(dtype) * m  # (O, L)
    per_obs = torch.cat([(J_full.mT @ J_hp).reshape(O, D * 3), (J_hp.mT @ J_hp).reshape(O, 9),
                         -(J_hp.mT @ res[..., None]).reshape(O, 3)], dim=1)
    by_lm = M.mT @ per_obs  # (L, 3 D + 12)
    W = by_lm[:, : D * 3].reshape(L, D, 3)
    H_ll = by_lm[:, D * 3: D * 3 + 9].reshape(L, 3, 3)
    b_l = by_lm[:, D * 3 + 9:]
    return H_dd, b_d, H_ll, b_l, W, cost


def evaluate_dense_factors(cfg: WindowConfig, imu_params: ImuParams, problem: BaProblem,
                           states: WindowStates):
    """IMU links + priors + marginal prior -> (H_dd, b_d, cost)."""
    dtype, device = states.r_WS.dtype, states.r_WS.device
    D = cfg.dense_dim
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

    # pose priors
    pp = problem.pose_priors
    pp_res, pp_J = pose_error(SE3(r=pp.r_meas, q=pp.q_meas), pp.sqrt_info,
                              SE3(r=states.r_WS[pp.state_idx], q=states.q_WS[pp.state_idx]))
    ppm = pp.mask.to(dtype)
    pp_res = pp_res * ppm[:, None]
    cost = cost + 0.5 * torch.sum(pp_res * pp_res)

    # speed/bias priors
    sp = problem.sb_priors
    sp_res, sp_J = speed_and_bias_error(sp.sb_meas, sp.sqrt_info, states.speed_and_bias[sp.state_idx])
    spm = sp.mask.to(dtype)
    sp_res = sp_res * spm[:, None]
    cost = cost + 0.5 * torch.sum(sp_res * sp_res)

    rows = [
        factor_rows(J30, cols, D).reshape(-1, D),
        factor_rows(pp_J * ppm[:, None, None], pp.state_idx[:, None] * 15 + col15[:6], D).reshape(-1, D),
        factor_rows(sp_J * spm[:, None, None], sp.state_idx[:, None] * 15 + col15[6:], D).reshape(-1, D),
    ]
    res = [imu_res.reshape(-1), pp_res.reshape(-1), sp_res.reshape(-1)]

    # relative-extrinsics drift links between consecutive per-state T_SC
    # blocks (the reference's relative-pose errors of variance sigma_c^2 dt)
    if cfg.extrinsics_per_state:
        el = problem.ext_links
        C = cfg.num_cameras
        el_res, el_J0, el_J1 = relative_pose_error(
            el.sqrt_info, SE3(r=states.r_SC_t[el.idx_a, el.cam], q=states.q_SC_t[el.idx_a, el.cam]),
            SE3(r=states.r_SC_t[el.idx_b, el.cam], q=states.q_SC_t[el.idx_b, el.cam]))
        elm = el.mask.to(dtype)
        el_res = el_res * elm[:, None]
        cost = cost + 0.5 * torch.sum(el_res * el_res)
        base = cfg.num_states * 15 + C * 6
        cols_el = torch.cat([base + (el.idx_a * C + el.cam)[:, None].to(torch.int64) * 6 + col15[:6],
                             base + (el.idx_b * C + el.cam)[:, None].to(torch.int64) * 6 + col15[:6]], dim=1)
        rows.append(factor_rows(torch.cat([el_J0, el_J1], dim=-1) * elm[:, None, None], cols_el, D).reshape(-1, D))
        res.append(el_res.reshape(-1))

    # every dense factor's rows in one product
    H_dd, b_d = normal_eqs_of_rows(torch.cat(rows), torch.cat(res))

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
