"""Batched quaternion / SO(3) operations (port of okvis_tpu.kinematics.so3).

Conventions match the JAX package and the reference implementation:

- Quaternions are (..., 4) tensors in **xyzw** order. Hamilton product,
  active rotations: ``C(q) @ v`` rotates v from the local frame into the
  frame q is expressed in (q_AB rotates B-vectors to A).
- ``delta_q(da) = [sinc(|da|/2) * da/2, cos(|da|/2)]`` — the exponential map
  of the reference's ``oplus`` (left perturbation).
- ``quat_left(q)``: q1*q2 = quat_left(q1) @ q2; ``quat_right(q)``:
  q1*q2 = quat_right(q2) @ q1.
- ``right_jacobian`` follows Forster et al. RSS 2015 eq. (8).

All functions broadcast over leading batch dimensions and keep the input's
dtype and device.
"""

from __future__ import annotations

import torch

from ..device import resolve_device


def sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x with a 6th-order Taylor series near zero."""
    small = x.abs() < 1e-6
    safe_x = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    series = 1.0 - x2 / 6.0 + (x2 * x2) / 120.0 - (x2 * x2 * x2) / 5040.0
    return torch.where(small, series, torch.sin(safe_x) / safe_x)


def safe_norm(v: torch.Tensor, dim=-1, keepdim=False) -> torch.Tensor:
    """||v|| with a finite derivative at v=0 (sqrt(sum(v²)+tiny))."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    return torch.sqrt(sq + torch.finfo(v.dtype).tiny)


def quat_identity(batch_shape=(), dtype=torch.float64, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=resolve_device(device))
    q[..., 3].fill_(1.0)  # fill_, not a copy from the host
    return q


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2, xyzw storage."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Inverse for unit quaternions: negate the vector part (no host-to-device
    copy, so the back end's loops stay free of host syncs)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


quat_inverse = quat_conjugate


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix C(q), shape (..., 3, 3); C(q_AB) maps B-vectors to A."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quat(C: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (xyzw), branch-free Shepperd method:
    all four candidates are formed and the best-conditioned one is selected."""
    m00, m01, m02 = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    m10, m11, m12 = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    m20, m21, m22 = C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]
    tr = m00 + m11 + m22
    # each candidate is (w, x, y, z) scaled by 4·c_k
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)
    norms = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(norms, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    sel = torch.gather(cand, -2, idx).squeeze(-2)  # (..., 4) in (w, x, y, z)
    q = quat_normalize(torch.stack([sel[..., 1], sel[..., 2], sel[..., 3], sel[..., 0]], dim=-1))
    # canonical sign: w >= 0
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion q without forming the matrix."""
    qv = q[..., :3]
    w = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def delta_q(d_alpha: torch.Tensor) -> torch.Tensor:
    """Exponential map of the reference oplus: [sinc(|da|/2)*da/2 ; cos(|da|/2)]."""
    half = 0.5 * safe_norm(d_alpha, dim=-1, keepdim=True)
    vec = sinc(half) * 0.5 * d_alpha
    return torch.cat([vec, torch.cos(half)], dim=-1)


def cross_matrix(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix [v]x, shape (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_left(q: torch.Tensor) -> torch.Tensor:
    """Left-multiplication matrix: q1*q2 = quat_left(q1) @ q2."""
    x, y, z, w = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([w, -z, y, x], dim=-1),
            torch.stack([z, w, -x, y], dim=-1),
            torch.stack([-y, x, w, z], dim=-1),
            torch.stack([-x, -y, -z, w], dim=-1),
        ],
        dim=-2,
    )


def quat_right(q: torch.Tensor) -> torch.Tensor:
    """Right-multiplication matrix: q1*q2 = quat_right(q2) @ q1."""
    x, y, z, w = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([w, z, -y, x], dim=-1),
            torch.stack([-z, w, x, y], dim=-1),
            torch.stack([y, -x, w, z], dim=-1),
            torch.stack([-x, -y, -z, w], dim=-1),
        ],
        dim=-2,
    )


def right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) right Jacobian J_r(phi) (Forster RSS'15 eq. 8):
    I - (1-cos|phi|)/|phi|² [phi]x + (|phi|-sin|phi|)/|phi|³ [phi]x²,
    with the small-angle series I - 0.5 [phi]x + 1/6 [phi]x²."""
    norm = safe_norm(phi, dim=-1)
    Px = cross_matrix(phi)
    Px2 = Px @ Px
    small = norm < 1e-4
    safe = torch.where(small, torch.ones_like(norm), norm)
    c1 = torch.where(small, 0.5, (1.0 - torch.cos(safe)) / (safe * safe))
    c2 = torch.where(small, 1.0 / 6.0, (safe - torch.sin(safe)) / (safe**3))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - c1[..., None, None] * Px + c2[..., None, None] * Px2
