"""Batched SE(3) transformations as (r, q) pairs (port of okvis_tpu.kinematics.se3).

- A transformation T_AB is the pair ``(r_AB, q_AB)``: ``p_A = C(q_AB) p_B + r_AB``.
- ``oplus(T, delta)``: ``r += delta[:3]; q = delta_q(delta[3:]) * q``.
- ``minus(T0, T1) = [r1 - r0; 2*vec(q1 * q0^-1)]``.
- ``oplus_jacobian`` (7x6) and ``lift_jacobian`` (6x7); lift is the
  pseudo-inverse of plus.

SE(3) elements are a NamedTuple of tensors ``r: (..., 3)`` and ``q: (..., 4)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from . import so3


class SE3(NamedTuple):
    """Rigid transform T_AB = (r_AB, q_AB); q in xyzw order."""

    r: torch.Tensor  # (..., 3)
    q: torch.Tensor  # (..., 4) xyzw

    @property
    def C(self) -> torch.Tensor:
        return so3.quat_to_matrix(self.q)

    def matrix(self) -> torch.Tensor:
        """Homogeneous 4x4 matrix."""
        batch = self.r.shape[:-1]
        T = self.r.new_zeros(batch + (4, 4))
        T[..., :3, :3] = self.C
        T[..., :3, 3] = self.r
        T[..., 3, 3].fill_(1.0)
        return T


def identity(batch_shape=(), dtype=torch.float64, device=None) -> SE3:
    device = resolve_device(device)
    return SE3(
        r=torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device),
        q=so3.quat_identity(batch_shape, dtype=dtype, device=device),
    )


def from_matrix(T: torch.Tensor) -> SE3:
    return SE3(r=T[..., :3, 3], q=so3.matrix_to_quat(T[..., :3, :3]))


def compose(T_AB: SE3, T_BC: SE3) -> SE3:
    """T_AC = T_AB * T_BC."""
    return SE3(
        r=so3.quat_rotate(T_AB.q, T_BC.r) + T_AB.r,
        q=so3.quat_multiply(T_AB.q, T_BC.q),
    )


def inverse(T_AB: SE3) -> SE3:
    """T_BA = (-C^T r, q^-1)."""
    q_inv = so3.quat_conjugate(T_AB.q)
    return SE3(r=-so3.quat_rotate(q_inv, T_AB.r), q=q_inv)


def transform_point(T_AB: SE3, p_B: torch.Tensor) -> torch.Tensor:
    """p_A = C p_B + r."""
    return so3.quat_rotate(T_AB.q, p_B) + T_AB.r


def transform_hpoint(T_AB: SE3, hp_B: torch.Tensor) -> torch.Tensor:
    """Homogeneous 4-vector transform: [C h[:3] + r*h[3]; h[3]]."""
    s = hp_B[..., 3:4]
    top = so3.quat_rotate(T_AB.q, hp_B[..., :3]) + T_AB.r * s
    return torch.cat([top, s], dim=-1)


def oplus(T: SE3, delta: torch.Tensor) -> SE3:
    """Minimal 6-dim update: r += dr, q = delta_q(dalpha)*q, renormalized."""
    dq = so3.delta_q(delta[..., 3:6])
    return SE3(
        r=T.r + delta[..., :3],
        q=so3.quat_normalize(so3.quat_multiply(dq, T.q)),
    )


def minus(T0: SE3, T1: SE3) -> torch.Tensor:
    """Minimal difference so that oplus(T0, minus(T0, T1)) ≈ T1 to first order."""
    dq = so3.quat_multiply(T1.q, so3.quat_conjugate(T0.q))
    return torch.cat([T1.r - T0.r, 2.0 * dq[..., :3]], dim=-1)


def oplus_jacobian(T: SE3) -> torch.Tensor:
    """d(T⊞delta)/d(delta) at delta=0: (..., 7, 6), rows [r(3); q xyzw(4)].

    [[I3, 0], [0, quat_right(q) @ 0.5*S]] with S = [I3; 0]."""
    batch = T.r.shape[:-1]
    J = T.r.new_zeros(batch + (7, 6))
    J[..., :3, :3] = torch.eye(3, dtype=T.r.dtype, device=T.r.device)
    S = T.r.new_zeros((4, 3))
    S[:3, :3] = 0.5 * torch.eye(3, dtype=T.r.dtype, device=T.r.device)
    J[..., 3:7, 3:6] = so3.quat_right(T.q) @ S
    return J


def lift_jacobian(T: SE3) -> torch.Tensor:
    """Minimal-from-ambient lift: (..., 6, 7), pseudo-inverse of oplus_jacobian.

    [[I3, 0], [0, 2*quat_right(q^-1)[0:3, 0:4]]]."""
    batch = T.r.shape[:-1]
    J = T.r.new_zeros(batch + (6, 7))
    J[..., :3, :3] = torch.eye(3, dtype=T.r.dtype, device=T.r.device)
    Qr = so3.quat_right(so3.quat_conjugate(T.q))
    J[..., 3:6, 3:7] = 2.0 * Qr[..., :3, :4]
    return J
