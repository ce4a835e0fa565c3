"""IMU preintegration and propagation (port of okvis_tpu.imu.preintegration).

The same trapezoidal integration of the orientation increment, rotation
integrals, bias sub-Jacobians and 15x15 covariance as the JAX package, over a
fixed number of padded sample intervals with per-interval masking. Where the
JAX package vmaps one factor, every function here takes leading batch
dimensions: timestamps (..., P), gyro and acc (..., P, 3), t0 and t1 (...),
sb_ref (..., 9); every field of the result carries the same leading
dimensions, so a window's K links preintegrate in one call.

- Full mode is a Python loop over the P-1 intervals with masked
  ``torch.where`` updates (the JAX package's ``lax.scan``).
- ``mean_only`` is the parallel-prefix form: the orientation chain is an
  inclusive quaternion prefix product by log-depth doubling (PyTorch has no
  ``associative_scan``), the acceleration integrals are cumulative sums.
- No operation reads a device value back to the host, so a caller on the
  card can run it under ``torch.cuda.set_sync_debug_mode("error")``, and
  ``PreintegrationGraph`` records full mode as one CUDA graph.

Boundary intervals are clipped to [t0, t1] with linearly interpolated
measurements; padded intervals (dt <= 0) change nothing; saturated gyro or
accelerometer samples inflate that interval's noise sigma 100x. Timestamps
are seconds from a caller-chosen origin: rebase them to the link's first
sample before casting to float32.

State-error ordering (15): [dp(3), dalpha(3), dv(3), db_g(3), db_a(3)].
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from ..device import resolve_device
from ..kinematics import so3
from ..kinematics.se3 import SE3
from ..linalg import cholesky
from ..utils import cuda_graph
from ..utils.timing import Timer


class ImuParams(NamedTuple):
    """IMU noise and saturation parameters (0-d tensors, a0 (3,))."""

    sigma_g_c: torch.Tensor  # gyro noise density [rad/s/sqrt(Hz)]
    sigma_a_c: torch.Tensor  # accel noise density [m/s^2/sqrt(Hz)]
    sigma_gw_c: torch.Tensor  # gyro drift noise density
    sigma_aw_c: torch.Tensor  # accel drift noise density
    g: torch.Tensor  # gravity magnitude [m/s^2]
    g_max: torch.Tensor  # gyro saturation [rad/s]
    a_max: torch.Tensor  # accel saturation [m/s^2]
    sigma_bg: torch.Tensor  # gyro bias prior std (first-frame prior)
    sigma_ba: torch.Tensor  # accel bias prior std
    a0: torch.Tensor  # (3,) prior accelerometer bias
    rate: int = 200  # nominal IMU rate [Hz]

    @staticmethod
    def euroc(dtype: torch.dtype = torch.float64, device=None) -> "ImuParams":
        """The EuRoC reference configuration's values (as the JAX package's
        ImuParams.euroc)."""
        device = resolve_device(device)

        def f(v):
            return torch.full((), v, dtype=dtype, device=device)

        return ImuParams(
            sigma_g_c=f(12.0e-4),
            sigma_a_c=f(8.0e-3),
            sigma_gw_c=f(4.0e-6),
            sigma_aw_c=f(4.0e-5),
            g=f(9.81007),
            g_max=f(7.8),
            a_max=f(176.0),
            sigma_bg=f(0.03),
            sigma_ba=f(0.1),
            a0=torch.zeros(3, dtype=dtype, device=device),
            rate=200,
        )


class PreintegratedImu(NamedTuple):
    """Preintegrated increment between two states (all in the S0 frame);
    every field has the caller's leading batch dimensions."""

    delta_q: torch.Tensor  # (..., 4) xyzw: orientation increment q_S0_S1
    C_integral: torch.Tensor  # (..., 3, 3) integral of C dt
    C_doubleintegral: torch.Tensor  # (..., 3, 3) double integral of C dt^2
    acc_integral: torch.Tensor  # (..., 3) integral of C a dt
    acc_doubleintegral: torch.Tensor  # (..., 3) double integral of C a dt^2
    dalpha_db_g: torch.Tensor  # (..., 3, 3)
    dv_db_g: torch.Tensor  # (..., 3, 3)
    dp_db_g: torch.Tensor  # (..., 3, 3)
    P_delta: torch.Tensor  # (..., 15, 15) increment covariance
    sqrt_info: torch.Tensor  # (..., 15, 15) upper-triangular S, S^T S = P_delta^-1
    delta_t: torch.Tensor  # (...) total integration time
    sb_ref: torch.Tensor  # (..., 9) speed-and-bias linearization point


def gravity_vector(params: ImuParams, dtype: torch.dtype = None) -> torch.Tensor:
    """g_W = g * [0, 0, 1]."""
    g = params.g if dtype is None else params.g.to(dtype)
    return torch.cat([g.new_zeros(2), g.reshape(1)])


def mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product A @ v over leading dimensions."""
    return (A @ v[..., None])[..., 0]


def as_time(t, like: torch.Tensor) -> torch.Tensor:
    """A time bound as a tensor in `like`'s dtype and device; a Python number
    is filled on the device rather than copied from the host."""
    if isinstance(t, torch.Tensor):
        return t.to(like.dtype)
    return torch.full((), float(t), dtype=like.dtype, device=like.device)


def _interval_quantities(ts, gyro, acc, t0, t1):
    """Per-interval clipped dt (..., P-1) and the measurements interpolated at
    the clipped ends, w0, w1, a0, a1 (..., P-1, 3)."""
    t_a, t_b = ts[..., :-1], ts[..., 1:]
    seg0 = torch.maximum(t_a, t0[..., None])
    seg1 = torch.minimum(t_b, t1[..., None])
    dt = torch.clamp(seg1 - seg0, min=0.0)
    span = t_b - t_a
    safe_span = torch.where(span > 0, span, torch.ones_like(span))
    f0 = torch.clamp((seg0 - t_a) / safe_span, 0.0, 1.0)[..., None]
    f1 = torch.clamp((seg1 - t_a) / safe_span, 0.0, 1.0)[..., None]
    g_a, g_b = gyro[..., :-1, :], gyro[..., 1:, :]
    a_a, a_b = acc[..., :-1, :], acc[..., 1:, :]
    w0 = (1.0 - f0) * g_a + f0 * g_b
    w1 = (1.0 - f1) * g_a + f1 * g_b
    a0 = (1.0 - f0) * a_a + f0 * a_b
    a1 = (1.0 - f1) * a_a + f1 * a_b
    return dt, w0, w1, a0, a1


def quat_prefix_product(q: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products q_0 * q_1 * ... * q_i along dim -2, in
    ceil(log2 N) doubling steps (Hillis-Steele; the earlier factor stays on
    the left, so the non-commutative product keeps its order)."""
    n, s = q.shape[-2], 1
    while s < n:
        q = torch.cat([q[..., :s, :], so3.quat_multiply(q[..., :-s, :], q[..., s:, :])], dim=-2)
        s *= 2
    return q


def _eye_batch(n: int, batch, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).repeat(*batch, 1, 1)


def _preintegrate_mean(dt_all, w0_all, w1_all, a0_all, a1_all, sb_ref) -> PreintegratedImu:
    """mean_only: delta_q and the acceleration integrals by parallel prefix;
    the other fields are zeros. Padded dt = 0 intervals contribute identity
    and zero terms, so no masking is needed."""
    omega_true = 0.5 * (w0_all + w1_all) - sb_ref[..., None, 3:6]
    acc_true = 0.5 * (a0_all + a1_all) - sb_ref[..., None, 6:9]
    dts = dt_all[..., None]
    Q = quat_prefix_product(so3.delta_q(omega_true * dts))  # (..., N, 4) inclusive
    ident = torch.zeros_like(Q[..., :1, :])
    ident[..., 3].fill_(1.0)  # fill_: a scalar setitem copies from the host (a sync)
    P_pre = torch.cat([ident, Q[..., :-1, :]], dim=-2)  # exclusive
    C_sum = so3.quat_to_matrix(P_pre) + so3.quat_to_matrix(Q)
    incr_v = 0.5 * mv(C_sum, acc_true) * dts
    prefix_v = torch.cumsum(incr_v, dim=-2) - incr_v  # exclusive
    batch = dt_all.shape[:-1]
    zeros33 = dt_all.new_zeros(batch + (3, 3))
    zeros1515 = dt_all.new_zeros(batch + (15, 15))
    return PreintegratedImu(
        delta_q=Q[..., -1, :],
        C_integral=zeros33,
        C_doubleintegral=zeros33,
        acc_integral=incr_v.sum(dim=-2),
        acc_doubleintegral=(prefix_v * dts + 0.5 * incr_v * dts).sum(dim=-2),
        dalpha_db_g=zeros33,
        dv_db_g=zeros33,
        dp_db_g=zeros33,
        P_delta=zeros1515,
        sqrt_info=zeros1515,
        delta_t=dt_all.sum(dim=-1),
        sb_ref=sb_ref,
    )


def preintegrate(
    params: ImuParams,
    timestamps: torch.Tensor,  # (..., P) seconds (padded; padding repeats the last)
    gyro: torch.Tensor,  # (..., P, 3)
    acc: torch.Tensor,  # (..., P, 3)
    t0,  # (...) start time
    t1,  # (...) end time
    sb_ref: torch.Tensor,  # (..., 9) [v, b_g, b_a] linearization point
    mean_only: bool = False,
) -> PreintegratedImu:
    """Preintegrate every link of the batch.

    mean_only=True skips the bias Jacobians, the covariance and its inverse:
    state prediction reads only delta_q and the acceleration integrals. The
    skipped fields come back as zeros; factors need the default full mode."""
    t0, t1 = as_time(t0, gyro), as_time(t1, gyro)
    dt_all, w0_all, w1_all, a0_all, a1_all = _interval_quantities(timestamps, gyro, acc, t0, t1)
    if mean_only:
        return _preintegrate_mean(dt_all, w0_all, w1_all, a0_all, a1_all, sb_ref)

    batch = dt_all.shape[:-1]
    b_g, b_a = sb_ref[..., 3:6], sb_ref[..., 6:9]
    eye3 = torch.eye(3, dtype=gyro.dtype, device=gyro.device)
    eye15 = _eye_batch(15, batch, gyro)
    z33 = gyro.new_zeros(batch + (3, 3))
    z3 = gyro.new_zeros(batch + (3,))
    dq0 = gyro.new_zeros(batch + (4,))
    dq0[..., 3].fill_(1.0)
    # the scan's carry, as in the JAX package
    c = dict(delta_q=dq0, C_integral=z33, C_doubleintegral=z33, acc_integral=z3,
             acc_doubleintegral=z3, cross=z33, dalpha_db_g=z33, dv_db_g=z33, dp_db_g=z33,
             P_delta=gyro.new_zeros(batch + (15, 15)), delta_t=gyro.new_zeros(batch))
    for n in range(dt_all.shape[-1]):
        dt = dt_all[..., n]
        w0, w1, a0, a1 = w0_all[..., n, :], w1_all[..., n, :], a0_all[..., n, :], a1_all[..., n, :]
        dtv, dtm = dt[..., None], dt[..., None, None]

        omega_true = 0.5 * (w0 + w1) - b_g
        acc_true = 0.5 * (a0 + a1) - b_a

        # orientation increment (trapezoid midpoint)
        dq = so3.delta_q(omega_true * dtv)
        delta_q_1 = so3.quat_multiply(c["delta_q"], dq)
        C = so3.quat_to_matrix(c["delta_q"])
        C_1 = so3.quat_to_matrix(delta_q_1)
        C_sum = C + C_1
        acc_integral_1 = c["acc_integral"] + mv(0.5 * C_sum, acc_true) * dtv
        acc_doubleintegral_1 = (c["acc_doubleintegral"] + c["acc_integral"] * dtv
                                + mv(0.25 * C_sum, acc_true) * dtv * dtv)

        # saturation -> 100x sigma inflation
        sat_g = ((w0.abs() > params.g_max) | (w1.abs() > params.g_max)).any(dim=-1)
        sat_a = ((a0.abs() > params.a_max) | (a1.abs() > params.a_max)).any(dim=-1)
        sigma_g = torch.where(sat_g, 100.0 * params.sigma_g_c, params.sigma_g_c)
        sigma_a = torch.where(sat_a, 100.0 * params.sigma_a_c, params.sigma_a_c)

        C_integral_1 = c["C_integral"] + 0.5 * C_sum * dtm
        C_doubleintegral_1 = c["C_doubleintegral"] + c["C_integral"] * dtm + 0.25 * C_sum * dtm * dtm

        # bias sub-Jacobians
        Jr = so3.right_jacobian(omega_true * dtv)
        dalpha_db_g_1 = c["dalpha_db_g"] + C_1 @ Jr * dtm
        cross_1 = so3.quat_to_matrix(so3.quat_conjugate(dq)) @ c["cross"] + Jr * dtm
        acc_x = so3.cross_matrix(acc_true)
        mix = C @ acc_x @ c["cross"] + C_1 @ acc_x @ cross_1
        dv_db_g_1 = c["dv_db_g"] + 0.5 * dtm * mix
        dp_db_g_1 = c["dp_db_g"] + dtm * c["dv_db_g"] + 0.25 * dtm * dtm * mix

        # covariance propagation
        F = eye15.clone()
        F[..., 0:3, 3:6] = -so3.cross_matrix(c["acc_integral"] * dtv + mv(0.25 * C_sum, acc_true) * dtv * dtv)
        F[..., 0:3, 6:9] = eye3 * dtm
        F[..., 0:3, 9:12] = dtm * c["dv_db_g"] + 0.25 * dtm * dtm * mix
        F[..., 0:3, 12:15] = -c["C_integral"] * dtm + 0.25 * C_sum * dtm * dtm
        F[..., 3:6, 9:12] = -dtm * C_1
        F[..., 6:9, 3:6] = -so3.cross_matrix(mv(0.5 * C_sum, acc_true) * dtv)
        F[..., 6:9, 9:12] = 0.5 * dtm * mix
        F[..., 6:9, 12:15] = -0.5 * C_sum * dtm
        P_1 = F @ c["P_delta"] @ F.mT
        noise = torch.stack([
            0.5 * dt * dt * dt * sigma_a * sigma_a,
            dt * sigma_g * sigma_g,
            dt * sigma_a * sigma_a,
            dt * params.sigma_gw_c * params.sigma_gw_c,
            dt * params.sigma_aw_c * params.sigma_aw_c,
        ], dim=-1)  # (..., 5): each repeats over its three dims
        P_1 = P_1 + torch.diag_embed(noise[..., :, None].expand(batch + (5, 3)).reshape(batch + (15,)))

        new = dict(delta_q=delta_q_1, C_integral=C_integral_1, C_doubleintegral=C_doubleintegral_1,
                   acc_integral=acc_integral_1, acc_doubleintegral=acc_doubleintegral_1, cross=cross_1,
                   dalpha_db_g=dalpha_db_g_1, dv_db_g=dv_db_g_1, dp_db_g=dp_db_g_1, P_delta=P_1,
                   delta_t=c["delta_t"] + dt)
        # masked update for padded or out-of-range intervals
        active = dt > 0
        c = {k: torch.where(active.reshape(batch + (1,) * (v.dim() - len(batch))), v, c[k])
             for k, v in new.items()}

    P = 0.5 * (c["P_delta"] + c["P_delta"].mT)
    # Invert through the correlation matrix: diag(P) spans ~1e-12 (biases) to
    # ~1e-6 (position), so a raw inverse loses everything in float32.
    d = torch.sqrt(torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1), min=1e-24))
    Pc = P / (d[..., :, None] * d[..., None, :])
    info_c, _ = torch.linalg.inv_ex(Pc + 1e-9 * eye15)
    info_c = 0.5 * (info_c + info_c.mT)
    Lc = cholesky(info_c)
    # sqrt_info = Lc^T D^-1 satisfies S^T S = D^-1 info_c D^-1 = P^-1
    sqrt_info = Lc.mT / d[..., None, :]

    return PreintegratedImu(
        delta_q=c["delta_q"],
        C_integral=c["C_integral"],
        C_doubleintegral=c["C_doubleintegral"],
        acc_integral=c["acc_integral"],
        acc_doubleintegral=c["acc_doubleintegral"],
        dalpha_db_g=c["dalpha_db_g"],
        dv_db_g=c["dv_db_g"],
        dp_db_g=c["dp_db_g"],
        P_delta=P,
        sqrt_info=sqrt_info,
        delta_t=c["delta_t"],
        sb_ref=sb_ref,
    )


class PreintegrationGraph:
    """Full-mode ``preintegrate`` recorded once as a CUDA graph per (device,
    dtype, batch shape) of its inputs and replayed on every call: the
    counterpart of the JAX package's jitted preintegration.

    Eagerly, each of the P-1 intervals is ~355 small launches, each waiting
    on the host; a replay is one graph launch of the same kernels in the
    same order, so its fields equal the eager call's bit for bit. A shape's
    first call warms up once on the capture stream, then records
    (`utils.cuda_graph.record`); the caller's other threads may keep
    launching meanwhile. Every call copies its inputs, tensors on the card,
    into the graph's static buffers and returns clones of the static
    outputs, so one call's fields survive the next replay. The Timers
    ``preintegrate.capture`` and ``preintegrate.replay`` count both."""

    def __init__(self, params: ImuParams):
        self.params = params
        # (device, dtype, gyro's leading shape) -> (graph, static inputs, static outputs)
        self.graphs = {}

    def __call__(self, timestamps, gyro, acc, t0, t1, sb_ref) -> PreintegratedImu:
        args = (timestamps, gyro, acc, t0, t1, sb_ref)
        key = (gyro.device, gyro.dtype, tuple(gyro.shape[:-1]))
        if key not in self.graphs:
            with Timer("preintegrate.capture"):
                self.graphs[key] = self._capture(args)
        graph, inputs, out = self.graphs[key]
        with Timer("preintegrate.replay"):
            for buf, x in zip(inputs, args):
                buf.copy_(x)
            graph.replay()
        return PreintegratedImu(*(x.clone() for x in out))

    def _capture(self, args) -> tuple:
        inputs = tuple(x.clone() for x in args)
        fn = functools.partial(preintegrate, self.params)
        cuda_graph.run(fn, *inputs, device=args[0].device)
        graph, out = cuda_graph.record(fn, *inputs, device=args[0].device)
        return graph, inputs, tuple(out)


def propagate(
    params: ImuParams,
    T_WS: SE3,
    speed_and_bias: torch.Tensor,  # (..., 9)
    timestamps: torch.Tensor,
    gyro: torch.Tensor,
    acc: torch.Tensor,
    t0,
    t1,
    mean_only: bool = True,
) -> Tuple[SE3, torch.Tensor]:
    """Forward state propagation T_WS(t0) -> T_WS(t1): the preintegrated
    increment composed with gravity in the world frame,
        q1 = q0 * dq
        v1 = v0 - g dt + C_WS0 * integral(C a dt)
        r1 = r0 + v0 dt - g dt^2 / 2 + C_WS0 * double integral(C a dt^2)."""
    pre = preintegrate(params, timestamps, gyro, acc, t0, t1, speed_and_bias, mean_only=mean_only)
    g_W = gravity_vector(params, dtype=gyro.dtype)
    C_WS0 = so3.quat_to_matrix(T_WS.q)
    dt = pre.delta_t[..., None]
    v0 = speed_and_bias[..., :3]
    r1 = T_WS.r + v0 * dt - 0.5 * g_W * dt * dt + mv(C_WS0, pre.acc_doubleintegral)
    q1 = so3.quat_normalize(so3.quat_multiply(T_WS.q, pre.delta_q))
    v1 = v0 - g_W * dt + mv(C_WS0, pre.acc_integral)
    return SE3(r=r1, q=q1), torch.cat([v1, speed_and_bias[..., 3:]], dim=-1)


def init_pose_from_imu(acc_mean: torch.Tensor) -> SE3:
    """Gravity-aligned initial pose from the mean accelerometer reading:
    q_WS = delta_q(-angle * axis), axis = normalize(e_z x e_acc),
    angle = acos(e_z . e_acc); zero position, yaw left free."""
    e_acc = acc_mean / torch.linalg.norm(acc_mean, dim=-1, keepdim=True)
    ez = torch.zeros_like(e_acc)
    ez[..., 2].fill_(1.0)
    axis_raw = torch.linalg.cross(ez, e_acc, dim=-1)
    n = so3.safe_norm(axis_raw, keepdim=True)
    small = n < 1e-12
    axis = axis_raw / torch.where(small, torch.ones_like(n), n)
    angle = torch.arccos(torch.clamp((ez * e_acc).sum(dim=-1, keepdim=True), -1.0, 1.0))
    alpha = torch.where(small, torch.zeros_like(axis), -angle * axis)
    return SE3(r=torch.zeros_like(e_acc), q=so3.delta_q(alpha))
