"""Pinhole camera with pluggable distortion (port of okvis_tpu.cameras.pinhole).

The camera is a hashable static spec (distortion type + image size) plus an
intrinsics tensor [fu, fv, cu, cv, d0..dK-1]. Every function takes a batch
of points (..., 3) / (..., 4) / (..., 2) where the JAX package took one
point under vmap; the intrinsics may carry leading dims that broadcast
against the points' batch without the last point dim (e.g. (G, 1, N)
against (G, K, 3)), so one call projects several cameras. The Jacobians (``jax.jacfwd`` in the JAX package) are
analytic: the chain rule through the distortion model's Jacobians.

Projection status is (uv, flags) with flags an int32: 0=successful,
1=invalid (singular), 2=outside image, 4=behind camera (combinable bits).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..device import resolve_device
from . import distortion as dist

# Projection status flag bits (combinable).
STATUS_OK = 0
STATUS_INVALID = 1
STATUS_OUTSIDE = 2
STATUS_BEHIND = 4


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Static part of a camera model."""

    width: int
    height: int
    dist_type: str  # 'none' | 'radtan' | 'radtan8' | 'equidistant'

    @property
    def num_intrinsics(self) -> int:
        return 4 + dist.NUM_DIST_PARAMS[self.dist_type]


def intrinsics_vector(fu, fv, cu, cv, dist_params=(), dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.tensor([fu, fv, cu, cv, *dist_params], dtype=dtype, device=resolve_device(device))


def project(spec: CameraSpec, intrinsics: torch.Tensor, p_C: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project Euclidean camera-frame points -> pixel (uv, status_flags):
    divide by z, distort, scale+offset."""
    fu, fv, cu, cv = intrinsics[..., 0], intrinsics[..., 1], intrinsics[..., 2], intrinsics[..., 3]
    dparams = intrinsics[..., 4:]
    z = p_C[..., 2]
    singular = z.abs() < 1e-12
    rz = 1.0 / torch.where(singular, torch.ones_like(z), z)
    xy = p_C[..., :2] * rz[..., None]
    xy_d = dist.distort(spec.dist_type, dparams, xy)
    u = fu * xy_d[..., 0] + cu
    v = fv * xy_d[..., 1] + cv
    uv = torch.stack([u, v], dim=-1)
    inside = (u >= -0.5) & (u <= spec.width - 0.5) & (v >= -0.5) & (v <= spec.height - 0.5)
    flags = (
        singular.to(torch.int32) * STATUS_INVALID
        + (~inside).to(torch.int32) * STATUS_OUTSIDE
        + (z <= 0.0).to(torch.int32) * STATUS_BEHIND
    )
    return uv, flags


def project_homogeneous(spec: CameraSpec, intrinsics: torch.Tensor, hp_C: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project homogeneous points, flipping the direction for negative scale."""
    s = hp_C[..., 3]
    p = torch.where(s[..., None] < 0, -hp_C[..., :3], hp_C[..., :3])
    return project(spec, intrinsics, p)


def project_jacobian_point(spec: CameraSpec, intrinsics: torch.Tensor, p_C: torch.Tensor
                           ) -> torch.Tensor:
    """d(uv)/d(p_C): (..., 2, 3) = diag(fu, fv) · J_distort · d(xy)/d(p_C).
    A singular z holds 1/z at 1, so its column is zero there."""
    z = p_C[..., 2]
    singular = z.abs() < 1e-12
    rz = 1.0 / torch.where(singular, torch.ones_like(z), z)
    xy = p_C[..., :2] * rz[..., None]
    Jd = dist.distort_jacobian(spec.dist_type, intrinsics[..., 4:], xy)  # (..., 2, 2)
    dz = torch.where(singular[..., None], torch.zeros_like(xy), -xy * rz[..., None])
    zero = torch.zeros_like(z)
    Jxy = torch.stack([
        torch.stack([rz, zero, dz[..., 0]], -1),
        torch.stack([zero, rz, dz[..., 1]], -1),
    ], -2)  # (..., 2, 3)
    f = torch.stack([intrinsics[..., 0], intrinsics[..., 1]], dim=-1)[..., None]
    return f * (Jd @ Jxy)


def project_homogeneous_jacobian(spec: CameraSpec, intrinsics: torch.Tensor, hp_C: torch.Tensor
                                 ) -> torch.Tensor:
    """d(uv)/d(hp_C): (..., 2, 4); the scale column is zero."""
    s = hp_C[..., 3]
    p = torch.where(s[..., None] < 0, -hp_C[..., :3], hp_C[..., :3])
    sign = torch.where(s < 0, -1.0, 1.0).to(hp_C.dtype)[..., None, None]
    Jp = sign * project_jacobian_point(spec, intrinsics, p)
    return torch.cat([Jp, torch.zeros_like(Jp[..., :1])], dim=-1)


def project_jacobian_intrinsics(spec: CameraSpec, intrinsics: torch.Tensor, p_C: torch.Tensor
                                ) -> torch.Tensor:
    """d(uv)/d(intrinsics): (..., 2, 4+K) for online calibration:
    [[xd, 0, 1, 0, fu·dxd/dk], [0, yd, 0, 1, fv·dyd/dk]]."""
    z = p_C[..., 2]
    rz = 1.0 / torch.where(z.abs() < 1e-12, torch.ones_like(z), z)
    xy = p_C[..., :2] * rz[..., None]
    dparams = intrinsics[4:]
    xy_d = dist.distort(spec.dist_type, dparams, xy)
    Jk = dist.distort_param_jacobian(spec.dist_type, dparams, xy)  # (..., 2, K)
    zero, one = torch.zeros_like(z), torch.ones_like(z)
    row_u = torch.stack([xy_d[..., 0], zero, one, zero], -1)
    row_v = torch.stack([zero, xy_d[..., 1], zero, one], -1)
    return torch.cat([
        torch.stack([row_u, row_v], -2),
        torch.stack([intrinsics[0] * Jk[..., 0, :], intrinsics[1] * Jk[..., 1, :]], -2),
    ], dim=-1)


def back_project(spec: CameraSpec, intrinsics: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> unit-z ray directions (x, y, 1) via iterative undistort."""
    fu, fv, cu, cv = intrinsics[..., 0], intrinsics[..., 1], intrinsics[..., 2], intrinsics[..., 3]
    dparams = intrinsics[..., 4:]
    xy_d = torch.stack([(uv[..., 0] - cu) / fu, (uv[..., 1] - cv) / fv], dim=-1)
    xy = dist.undistort(spec.dist_type, dparams, xy_d)
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
