"""Prior and drift factors (port of okvis_tpu.factors.priors), batched over
leading dimensions: absolute pose, relative pose, speed-and-bias and
homogeneous-point priors.

Error conventions (as the JAX package and the reference):
  pose:     e = [r_meas - r_est ; 2*vec(q_meas * q_est^-1)], J = -I with the
            rotation block -quat_left(dq)[:3, :3].
  relative: e = [r1 - r0 ; 2*vec(q1 * q0^-1)] (zero-measurement drift term).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kinematics import so3
from ..kinematics.se3 import SE3
from ..linalg import cholesky


def sqrt_information(information: torch.Tensor) -> torch.Tensor:
    """Upper-triangular L^T with L L^T = information."""
    return cholesky(information).mT


def _minus_eye(n: int, batch, like: torch.Tensor) -> torch.Tensor:
    # new_zeros of an input, so a torch.func.vmap batch carries into the
    # callers' in-place block writes
    return -(like.new_zeros((*batch, n, n)) + torch.eye(n, dtype=like.dtype, device=like.device))


def pose_error(T_meas: SE3, sqrt_info: torch.Tensor, T_est: SE3) -> Tuple[torch.Tensor, torch.Tensor]:
    """6-dim absolute pose prior: (residual (..., 6), J_minimal (..., 6, 6))."""
    dq = so3.quat_multiply(T_meas.q, so3.quat_conjugate(T_est.q))
    error = torch.cat([T_meas.r - T_est.r, 2.0 * dq[..., :3]], dim=-1)
    J = _minus_eye(6, error.shape[:-1], error)
    J[..., 3:6, 3:6] = -so3.quat_left(dq)[..., :3, :3]
    return (sqrt_info @ error[..., None])[..., 0], sqrt_info @ J


def relative_pose_error(sqrt_info: torch.Tensor, T0: SE3, T1: SE3
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """6-dim relative drift factor between two poses: (residual, J0, J1)."""
    dq = so3.quat_multiply(T1.q, so3.quat_conjugate(T0.q))
    error = torch.cat([T1.r - T0.r, 2.0 * dq[..., :3]], dim=-1)
    J0 = _minus_eye(6, error.shape[:-1], error)
    J0[..., 3:6, 3:6] = -so3.quat_left(dq)[..., :3, :3]
    J1 = -_minus_eye(6, error.shape[:-1], error)
    J1[..., 3:6, 3:6] = so3.quat_right(dq)[..., :3, :3]
    return (sqrt_info @ error[..., None])[..., 0], sqrt_info @ J0, sqrt_info @ J1


def speed_and_bias_error(sb_meas: torch.Tensor, sqrt_info: torch.Tensor, sb_est: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """9-dim prior: e = meas - est, J = -I."""
    residual = (sqrt_info @ (sb_meas - sb_est)[..., None])[..., 0]
    return residual, sqrt_info @ _minus_eye(9, residual.shape[:-1], sb_est)


def homogeneous_point_error(hp_meas: torch.Tensor, sqrt_info: torch.Tensor, hp_est: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-dim landmark prior on the Euclidean part: e = (meas - est)[:3]."""
    residual = (sqrt_info @ (hp_meas[..., :3] - hp_est[..., :3])[..., None])[..., 0]
    return residual, sqrt_info @ _minus_eye(3, residual.shape[:-1], hp_est)
