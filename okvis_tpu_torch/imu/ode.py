"""RK4 continuous-time IMU integration (port of okvis_tpu.imu.ode).

An accuracy cross-check of the trapezoidal propagation in
``preintegration.py``, batched over leading dimensions like it.

State: (r_W (3), q_WS (4), v_W (3)); biases held constant over the step.
ODE:  r' = v,  q' = q * [w - b_g, 0] / 2,  v' = C(q)(a - b_a) - g e_z.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kinematics import so3
from ..kinematics.se3 import SE3
from .preintegration import ImuParams, _interval_quantities, as_time, gravity_vector


def _state_dot(g_W, r, q, v, omega, acc, b_g, b_a):
    del r
    w = omega - b_g
    q_dot = 0.5 * so3.quat_multiply(q, torch.cat([w, torch.zeros_like(w[..., :1])], dim=-1))
    v_dot = so3.quat_rotate(q, acc - b_a) - g_W
    return v, q_dot, v_dot


def propagate_rk4(
    params: ImuParams,
    T_WS: SE3,
    speed_and_bias: torch.Tensor,  # (..., 9)
    timestamps: torch.Tensor,  # (..., P) seconds, padded
    gyro: torch.Tensor,  # (..., P, 3)
    acc: torch.Tensor,  # (..., P, 3)
    t0,
    t1,
) -> Tuple[SE3, torch.Tensor]:
    """Classic RK4 over each clipped sample interval, with the measurements
    interpolated linearly at the half step."""
    dt_all, w0_all, w1_all, a0_all, a1_all = _interval_quantities(
        timestamps, gyro, acc, as_time(t0, gyro), as_time(t1, gyro))
    g_W = gravity_vector(params, dtype=gyro.dtype)
    b_g, b_a = speed_and_bias[..., 3:6], speed_and_bias[..., 6:9]
    r, q, v = T_WS.r, T_WS.q, speed_and_bias[..., :3]
    for n in range(dt_all.shape[-1]):
        dt = dt_all[..., n, None]
        w0, w1, a0, a1 = w0_all[..., n, :], w1_all[..., n, :], a0_all[..., n, :], a1_all[..., n, :]
        wm, am = 0.5 * (w0 + w1), 0.5 * (a0 + a1)
        k1 = _state_dot(g_W, r, q, v, w0, a0, b_g, b_a)
        k2 = _state_dot(g_W, r + 0.5 * dt * k1[0], q + 0.5 * dt * k1[1], v + 0.5 * dt * k1[2],
                        wm, am, b_g, b_a)
        k3 = _state_dot(g_W, r + 0.5 * dt * k2[0], q + 0.5 * dt * k2[1], v + 0.5 * dt * k2[2],
                        wm, am, b_g, b_a)
        k4 = _state_dot(g_W, r + dt * k3[0], q + dt * k3[1], v + dt * k3[2], w1, a1, b_g, b_a)
        r1 = r + dt / 6.0 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        q1 = so3.quat_normalize(q + dt / 6.0 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1]))
        v1 = v + dt / 6.0 * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2])
        active = dt > 0
        r, q, v = torch.where(active, r1, r), torch.where(active, q1, q), torch.where(active, v1, v)
    return SE3(r=r, q=q), torch.cat([v, speed_and_bias[..., 3:]], dim=-1)
