"""Reprojection factor: 2-dim residual and analytic minimal Jacobians (port
of okvis_tpu.factors.reprojection), batched over observations.

Transform the homogeneous world landmark through T_CS * T_SW, project with
the camera's analytic Jacobian (cameras/pinhole.py), weight by the sqrt
information. Points closer than 20 cm or behind the camera zero the
Jacobians but keep the residual (the reference's `valid` flag).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..cameras import pinhole
from ..cameras.pinhole import CameraSpec
from ..imu.preintegration import mv
from ..kinematics import so3
from ..kinematics.se3 import SE3


class ReprojectionJacobians(NamedTuple):
    J_pose: torch.Tensor  # (..., 2, 6) with respect to T_WS minimal
    J_hp: torch.Tensor  # (..., 2, 3) with respect to the landmark's first 3 coordinates
    J_ext: torch.Tensor  # (..., 2, 6) with respect to T_SC minimal


def _hmat(C: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous transforms [[C, t], [0, 1]], batched."""
    top = torch.cat([C, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3].fill_(1.0)  # fill_: a scalar setitem copies from the host (a sync)
    return torch.cat([top, bottom], dim=-2)


def _jac_4x6(C: torch.Tensor, scale: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[[C * scale, -C [p]x], [0, 0]]: d(T^-1 hp)/d(T minimal), batched."""
    top = torch.cat([C * scale[..., None, None], -C @ so3.cross_matrix(p)], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def reprojection_error(
    spec: CameraSpec,
    intrinsics: torch.Tensor,  # (4+K,) one camera's intrinsics
    kp: torch.Tensor,  # (..., 2) measured keypoint
    sqrt_info,  # isotropic weight (a number, or (...) per keypoint), or (..., 2, 2)
    T_WS: SE3,
    hp_W: torch.Tensor,  # (..., 4) homogeneous landmark in W
    T_SC: SE3,
) -> Tuple[torch.Tensor, ReprojectionJacobians, torch.Tensor]:
    """(weighted residual (..., 2), minimal Jacobians, valid flag (...))."""
    dtype = hp_W.dtype
    if not isinstance(sqrt_info, torch.Tensor):
        sqrt_info = torch.full((), float(sqrt_info), dtype=dtype, device=hp_W.device)
    if sqrt_info.dim() < kp.dim():  # isotropic: one weight, or one per keypoint
        sqrt_info = sqrt_info.to(dtype)[..., None, None] * torch.eye(2, dtype=dtype, device=hp_W.device)

    C_CS = so3.quat_to_matrix(T_SC.q).mT
    C_SW = so3.quat_to_matrix(T_WS.q).mT

    # hp_S = T_SW hp_W ; hp_C = T_CS hp_S (the scale coordinate is unchanged)
    s = hp_W[..., 3]
    p_w = hp_W[..., :3] - T_WS.r * s[..., None]
    hp_S3 = mv(C_SW, p_w)
    p_s = hp_S3 - T_SC.r * s[..., None]
    hp_C = torch.cat([mv(C_CS, p_s), hp_W[..., 3:4]], dim=-1)

    uv, _flags = pinhole.project_homogeneous(spec, intrinsics, hp_C)
    Jh_w = sqrt_info @ pinhole.project_homogeneous_jacobian(spec, intrinsics, hp_C)
    residual = mv(sqrt_info, kp - uv)

    # validity: the point lies at least 20 cm in front of the camera
    far = s.abs() > 1e-8
    z_over_w = hp_C[..., 2] / torch.where(far, s, torch.ones_like(s))
    valid = ~(far & (z_over_w < 0.2))

    T_CS_m = _hmat(C_CS, -mv(C_CS, T_SC.r))
    T_SW_m = _hmat(C_SW, -mv(C_SW, T_WS.r))
    J_pose = Jh_w @ T_CS_m @ _jac_4x6(C_SW, s, p_w)
    # landmark: Euclidean perturbation of the first 3 homogeneous coordinates
    J_hp = (-Jh_w @ (T_CS_m @ T_SW_m))[..., :, :3]
    J_ext = Jh_w @ _jac_4x6(C_CS, s, p_s)

    z = valid.to(dtype)[..., None, None]
    return residual, ReprojectionJacobians(J_pose=J_pose * z, J_hp=J_hp * z, J_ext=J_ext * z), valid
