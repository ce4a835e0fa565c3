"""Distortion models as batched torch functions (port of okvis_tpu.cameras.distortion).

Each model is a pair

    distort(params, xy)   -> distorted normalized image coords
    undistort(params, xy) -> inverse by a fixed 5-step Gauss-Newton solve

over (..., 2) tensors of normalized image-plane coordinates. The JAX package
takes the Jacobians from ``jax.jacfwd`` on one point and vmaps; here each
model has analytic Jacobians with respect to the point (``jacobian_<model>``,
(..., 2, 2)) and to its parameters (``param_jacobian_<model>``, (..., 2, K)),
held to jacfwd's values by the tests. (Forward mode through ``torch.func``
costs milliseconds of host time a call, more than the whole stereo step.)

Parameter layouts (reference YAML order):
    radtan      : [k1, k2, p1, p2]
    radtan8     : [k1, k2, p1, p2, k3, k4, k5, k6]   (rational model)
    equidistant : [k1, k2, k3, k4]                    (fisheye theta-poly)
    none        : []
"""

from __future__ import annotations

import torch

NUM_DIST_PARAMS = {"none": 0, "radtan": 4, "radtan8": 8, "equidistant": 4}


def distort_none(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    del params
    return xy


def distort_radtan(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Brown-Conrady k1,k2,p1,p2."""
    k1, k2, p1, p2 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    x2, y2, xy_ = x * x, y * y, x * y
    r2 = x2 + y2
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * xy_ + p2 * (r2 + 2.0 * x2)
    yd = y * radial + p1 * (r2 + 2.0 * y2) + 2.0 * p2 * xy_
    return torch.stack([xd, yd], dim=-1)


def distort_radtan8(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Rational 8-parameter model."""
    k1, k2, p1, p2 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    k3, k4, k5, k6 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
    x, y = xy[..., 0], xy[..., 1]
    x2, y2, xy_ = x * x, y * y, x * y
    r2 = x2 + y2
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
    radial = num / den
    xd = x * radial + 2.0 * p1 * xy_ + p2 * (r2 + 2.0 * x2)
    yd = y * radial + p1 * (r2 + 2.0 * y2) + 2.0 * p2 * xy_
    return torch.stack([xd, yd], dim=-1)


def distort_equidistant(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Fisheye equidistant k1..k4."""
    k1, k2, k3, k4 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    sq = x * x + y * y
    r = torch.sqrt(sq + torch.finfo(xy.dtype).tiny)
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    # scale = theta_d / r; near r=0 the limit is theta_d'(0) ≈ 1
    near = r < 1e-8
    scale = torch.where(near, torch.ones_like(r), theta_d / torch.where(near, torch.ones_like(r), r))
    return xy * scale[..., None]


def jacobian_none(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    del params
    eye = torch.eye(2, dtype=xy.dtype, device=xy.device)
    return eye.expand(*xy.shape[:-1], 2, 2)


def _radtan_jacobian(radial, drad_dr2, p1, p2, xy) -> torch.Tensor:
    """Jacobian of x·radial(r²) + tangential terms, shared by radtan and radtan8."""
    x, y = xy[..., 0], xy[..., 1]
    drx = drad_dr2 * 2.0 * x
    dry = drad_dr2 * 2.0 * y
    j00 = radial + x * drx + 2.0 * p1 * y + 6.0 * p2 * x
    j01 = x * dry + 2.0 * p1 * x + 2.0 * p2 * y
    j10 = y * drx + 2.0 * p1 * x + 2.0 * p2 * y
    j11 = radial + y * dry + 6.0 * p1 * y + 2.0 * p2 * x
    return torch.stack([torch.stack([j00, j01], -1), torch.stack([j10, j11], -1)], -2)


def jacobian_radtan(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    r2 = xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1]
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    return _radtan_jacobian(radial, k1 + 2.0 * k2 * r2, p1, p2, xy)


def jacobian_radtan8(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    k3, k4, k5, k6 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
    r2 = xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1]
    r4 = r2 * r2
    num = 1.0 + k1 * r2 + k2 * r4 + k3 * r4 * r2
    den = 1.0 + k4 * r2 + k5 * r4 + k6 * r4 * r2
    dnum = k1 + 2.0 * k2 * r2 + 3.0 * k3 * r4
    dden = k4 + 2.0 * k5 * r2 + 3.0 * k6 * r4
    return _radtan_jacobian(num / den, (dnum * den - num * dden) / (den * den), p1, p2, xy)


def jacobian_equidistant(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """d(xy·scale(r))/d(xy) = scale·I + xy ⊗ scale'(r)·xy/r (0 near r=0,
    where the model holds scale at 1)."""
    k1, k2, k3, k4 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(x * x + y * y + torch.finfo(xy.dtype).tiny)
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    dtheta_d = (1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4))))
    dtheta_d = dtheta_d / (1.0 + r * r)
    near = r < 1e-8
    safe_r = torch.where(near, torch.ones_like(r), r)
    scale = torch.where(near, torch.ones_like(r), theta_d / safe_r)
    dscale_dr = torch.where(near, torch.zeros_like(r), (dtheta_d * safe_r - theta_d) / (safe_r * safe_r))
    g = dscale_dr / r  # dscale/dx_j = g·x_j
    j00 = scale + x * g * x
    j01 = x * g * y
    j10 = y * g * x
    j11 = scale + y * g * y
    return torch.stack([torch.stack([j00, j01], -1), torch.stack([j10, j11], -1)], -2)


def param_jacobian_none(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    return xy.new_zeros(xy.shape[:-1] + (2, 0))


def _tangential_columns(xy: torch.Tensor):
    """d(distort)/d(p1), d(distort)/d(p2) of the radtan tangential terms."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    return (torch.stack([2.0 * x * y, r2 + 2.0 * y * y], -1),
            torch.stack([r2 + 2.0 * x * x, 2.0 * x * y], -1))


def param_jacobian_radtan(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    r2 = (xy * xy).sum(-1, keepdim=True)
    dp1, dp2 = _tangential_columns(xy)
    return torch.stack([xy * r2, xy * r2 * r2, dp1, dp2], -1)


def param_jacobian_radtan8(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    k1, k2, k3 = params[..., 0], params[..., 1], params[..., 4]
    k4, k5, k6 = params[..., 5], params[..., 6], params[..., 7]
    r2 = (xy * xy).sum(-1)
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
    a = (1.0 / den)[..., None] * xy  # d/d(num coefficient) per power
    b = (-num / (den * den))[..., None] * xy  # d/d(den coefficient) per power
    dp1, dp2 = _tangential_columns(xy)
    r2, r4, r6 = r2[..., None], r4[..., None], r6[..., None]
    return torch.stack([a * r2, a * r4, dp1, dp2, a * r6, b * r2, b * r4, b * r6], -1)


def param_jacobian_equidistant(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """d(xy·theta_d/r)/d(k_i) = xy·theta^(2i+1)/r (0 near r=0)."""
    r = torch.sqrt((xy * xy).sum(-1) + torch.finfo(xy.dtype).tiny)
    theta = torch.atan(r)
    near = r < 1e-8
    w = torch.where(near, torch.zeros_like(r), theta / torch.where(near, torch.ones_like(r), r))
    t2 = theta * theta
    cols = []
    for _ in range(4):
        w = w * t2
        cols.append(xy * w[..., None])
    return torch.stack(cols, -1)


_PARAM_JACOBIAN_FNS = {
    "none": param_jacobian_none,
    "radtan": param_jacobian_radtan,
    "radtan8": param_jacobian_radtan8,
    "equidistant": param_jacobian_equidistant,
}

_JACOBIAN_FNS = {
    "none": jacobian_none,
    "radtan": jacobian_radtan,
    "radtan8": jacobian_radtan8,
    "equidistant": jacobian_equidistant,
}

_DISTORT_FNS = {
    "none": distort_none,
    "radtan": distort_radtan,
    "radtan8": distort_radtan8,
    "equidistant": distort_equidistant,
}


def distort(dist_type: str, params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    return _DISTORT_FNS[dist_type](params, xy)


def distort_jacobian(dist_type: str, params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """d(distort)/d(xy), shape (..., 2, 2)."""
    return _JACOBIAN_FNS[dist_type](params, xy)


def distort_param_jacobian(dist_type: str, params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """d(distort)/d(params), shape (..., 2, K)."""
    return _PARAM_JACOBIAN_FNS[dist_type](params, xy)


def undistort(dist_type: str, params: torch.Tensor, xy_d: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Invert distort() by `iters` Gauss-Newton steps (the reference uses 5)."""
    if dist_type == "none":
        return xy_d
    fn = _DISTORT_FNS[dist_type]
    x = xy_d
    for _ in range(iters):
        e = fn(params, x) - xy_d
        J = distort_jacobian(dist_type, params, x)
        # 2x2 solve: x -= J^-1 e
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        inv_det = 1.0 / torch.where(det.abs() < 1e-12, torch.ones_like(det), det)
        dx = inv_det[..., None] * torch.stack(
            [
                J[..., 1, 1] * e[..., 0] - J[..., 0, 1] * e[..., 1],
                -J[..., 1, 0] * e[..., 0] + J[..., 0, 0] * e[..., 1],
            ],
            dim=-1,
        )
        x = x - dx
    return x
