"""IMU preintegration factor: 15-dim residual and analytic minimal Jacobians
(port of okvis_tpu.factors.imu_factor), batched over links.

The residual links (T_WS0, sb0) -> (T_WS1, sb1) through the preintegrated
increment, with first-order bias correction through the dalpha/dv/dp bias
sub-Jacobians. Every input carries the links' leading dimension (K,) where
the JAX package vmaps one factor.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..imu.preintegration import ImuParams, PreintegratedImu, gravity_vector, mv
from ..kinematics import so3
from ..kinematics.se3 import SE3


class ImuFactorJacobians(NamedTuple):
    J_pose0: torch.Tensor  # (..., 15, 6)
    J_sb0: torch.Tensor  # (..., 15, 9)
    J_pose1: torch.Tensor  # (..., 15, 6)
    J_sb1: torch.Tensor  # (..., 15, 9)


def imu_error(
    params: ImuParams,
    pre: PreintegratedImu,
    T_WS0: SE3,
    sb0: torch.Tensor,
    T_WS1: SE3,
    sb1: torch.Tensor,
) -> Tuple[torch.Tensor, ImuFactorJacobians]:
    """Weighted 15-dim residual [e_p, e_q, e_v, e_bg, e_ba], weighted by the
    preintegrated sqrt information, and the minimal Jacobians."""
    dt = pre.delta_t[..., None]
    dtm = pre.delta_t[..., None, None]
    g_W = gravity_vector(params, dtype=sb0.dtype)

    C_S0W = so3.quat_to_matrix(T_WS0.q).mT
    v0, v1 = sb0[..., :3], sb1[..., :3]
    delta_b = sb0[..., 3:9] - pre.sb_ref[..., 3:9]
    db_g = delta_b[..., :3]

    delta_p_est_W = T_WS0.r - T_WS1.r + v0 * dt - 0.5 * g_W * dt * dt
    delta_v_est_W = v0 - v1 - g_W * dt
    # first-order bias-corrected orientation increment
    Dq = so3.quat_multiply(so3.delta_q(-mv(pre.dalpha_db_g, db_g)), pre.delta_q)

    q1_inv = so3.quat_conjugate(T_WS1.q)
    q1inv_q0 = so3.quat_multiply(q1_inv, T_WS0.q)
    batch = delta_p_est_W.shape[:-1]
    eye15 = torch.eye(15, dtype=sb0.dtype, device=sb0.device)

    # Jacobian with respect to state 0; columns [dp0, dalpha0 | dv0, db_g0, db_a0]
    # built on new_zeros of an input, so a torch.func.vmap batch carries
    # into the in-place block writes
    F0 = C_S0W.new_zeros((*batch, 15, 15)) + eye15
    F0[..., 0:3, 0:3] = C_S0W
    F0[..., 0:3, 3:6] = C_S0W @ so3.cross_matrix(delta_p_est_W)
    F0[..., 0:3, 6:9] = C_S0W * dtm
    F0[..., 0:3, 9:12] = pre.dp_db_g
    F0[..., 0:3, 12:15] = -pre.C_doubleintegral
    F0[..., 3:6, 3:6] = (so3.quat_left(so3.quat_multiply(Dq, q1_inv))
                         @ so3.quat_right(T_WS0.q))[..., :3, :3]
    F0[..., 3:6, 9:12] = ((so3.quat_right(q1inv_q0) @ so3.quat_right(Dq))[..., :3, :3]
                          @ (-pre.dalpha_db_g))
    F0[..., 6:9, 3:6] = C_S0W @ so3.cross_matrix(delta_v_est_W)
    F0[..., 6:9, 6:9] = C_S0W
    F0[..., 6:9, 9:12] = pre.dv_db_g
    F0[..., 6:9, 12:15] = -pre.C_integral

    # Jacobian with respect to state 1
    F1 = -(C_S0W.new_zeros((*batch, 15, 15)) + eye15)
    F1[..., 0:3, 0:3] = -C_S0W
    F1[..., 3:6, 3:6] = -(so3.quat_left(Dq) @ so3.quat_right(T_WS0.q)
                          @ so3.quat_left(q1_inv))[..., :3, :3]
    F1[..., 6:9, 6:9] = -C_S0W

    error = torch.cat([
        mv(C_S0W, delta_p_est_W) + pre.acc_doubleintegral + mv(F0[..., 0:3, 9:15], delta_b),
        2.0 * so3.quat_multiply(Dq, q1inv_q0)[..., :3],
        mv(C_S0W, delta_v_est_W) + pre.acc_integral + mv(F0[..., 6:9, 9:15], delta_b),
        sb0[..., 3:9] - sb1[..., 3:9],
    ], dim=-1)

    W = pre.sqrt_info
    return mv(W, error), ImuFactorJacobians(
        J_pose0=W @ F0[..., :, 0:6],
        J_sb0=W @ F0[..., :, 6:15],
        J_pose1=W @ F1[..., :, 0:6],
        J_sb1=W @ F1[..., :, 6:15],
    )
