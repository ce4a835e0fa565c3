"""Fixed-shape problem structure of the sliding-window bundle adjustment
(port of okvis_tpu.solver.structure).

The whole window is a tree of NamedTuples of fixed-capacity tensors with
masks, the same slot layout as the JAX package, so every optimize call sees
the same shapes. Host bookkeeping (which slot holds which frame or landmark)
belongs to the estimator.

Minimal-coordinate layout of the dense parameter vector (dimension D):
    state i   : [dp dalpha]      at i*15 .. i*15+6
                [dv dbg dba]     at i*15+6 .. (i+1)*15
    camera c  : [dp dalpha]_SC   at S*15 + c*6 (online extrinsics, shared)
    per-state extrinsics (extrinsics_per_state: one T_SC block a state and
    camera, the reference's per-state T_SCi blocks):
    (i, c)    : [dp dalpha]_SC   at S*15 + C*6 + (i*C + c)*6
    D = S*15 + C*6 (+ S*C*6 when per-state)

Landmarks are L slots of 3 minimal dims (Euclidean perturbation of the
homogeneous point's first three components).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..cameras.pinhole import CameraSpec
from ..device import resolve_device
from ..imu.preintegration import PreintegratedImu
from ..kinematics.se3 import SE3


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    """Static capacities and solver options, the JAX package's fields.

    Defaults follow the EuRoC reference configuration: a window of
    5 keyframes + 3 IMU frames, 3..10 LM iterations."""

    num_states: int = 8  # S
    num_cameras: int = 2  # C
    max_landmarks: int = 512  # L
    max_observations: int = 2048  # O
    imu_samples: int = 32  # P: IMU samples per link window
    max_imu_links: int = 7  # K
    max_pose_priors: int = 2
    max_sb_priors: int = 2
    camera_specs: Tuple[CameraSpec, ...] = ()
    estimate_extrinsics: bool = False
    # temporally varying extrinsics: one T_SC block a (state, camera),
    # consecutive blocks linked by relative-pose drift factors; the shared
    # C*6 block is then masked out
    extrinsics_per_state: bool = False
    sigma_c_relative_translation: float = 0.0  # drift densities [m/sqrt(s)],
    sigma_c_relative_orientation: float = 0.0  # [rad/sqrt(s)]
    # absolute extrinsics prior sigmas of the first state's blocks (per-state
    # mode only; ~0 makes them quasi-constant by a stiff gauge prior)
    sigma_absolute_translation: float = 0.0
    sigma_absolute_orientation: float = 0.0
    max_iterations: int = 10
    min_iterations: int = 3
    cauchy_scale: float = 1.0  # the reference's CauchyLoss(1)
    init_lambda: float = 1e-4
    algorithm: str = "lm"  # 'lm' | 'dogleg'
    init_radius: float = 1e4  # dogleg initial trust-region radius
    dense_solver: str = "newton"  # 'newton' (Newton-Schulz) | 'cholesky'
    # the estimator's capacity tiers (not ported with this module)
    capacity_tiers: bool = True
    tier_divisors: Tuple[int, ...] = (4, 2)

    @property
    def dense_dim(self) -> int:
        d = self.num_states * 15 + self.num_cameras * 6
        if self.extrinsics_per_state:
            d += self.num_states * self.num_cameras * 6
        return d

    @property
    def ext_link_capacity(self) -> int:
        """Relative-extrinsics drift links: one per (IMU link, camera)."""
        return max(1, self.max_imu_links * self.num_cameras)

    def state_offset(self, i: int) -> int:
        return i * 15

    def ext_offset(self, c: int) -> int:
        return self.num_states * 15 + c * 6

    def ext_ps_offset(self, i: int, c: int) -> int:
        """Dense offset of state i's camera-c extrinsics block (per-state)."""
        return self.num_states * 15 + self.num_cameras * 6 + (i * self.num_cameras + c) * 6


class WindowStates(NamedTuple):
    """Optimizable window variables."""

    r_WS: torch.Tensor  # (S, 3)
    q_WS: torch.Tensor  # (S, 4)
    speed_and_bias: torch.Tensor  # (S, 9)
    r_SC: torch.Tensor  # (C, 3)
    q_SC: torch.Tensor  # (C, 4)
    hp_W: torch.Tensor  # (L, 4)
    # per-state extrinsics (only when cfg.extrinsics_per_state)
    r_SC_t: torch.Tensor = None  # (S, C, 3)
    q_SC_t: torch.Tensor = None  # (S, C, 4)

    def pose(self, i) -> SE3:
        return SE3(r=self.r_WS[i], q=self.q_WS[i])

    def extrinsics(self, c) -> SE3:
        return SE3(r=self.r_SC[c], q=self.q_SC[c])


class Observations(NamedTuple):
    """Padded reprojection-factor table."""

    state_idx: torch.Tensor  # (O,) int32 window slot
    cam_idx: torch.Tensor  # (O,) int32
    lm_idx: torch.Tensor  # (O,) int32 landmark slot
    keypoint: torch.Tensor  # (O, 2)
    sqrt_info: torch.Tensor  # (O,) isotropic weight
    mask: torch.Tensor  # (O,) bool


class ImuLinks(NamedTuple):
    """Padded IMU-factor table: preintegrated increments between state slots."""

    pre: PreintegratedImu  # batched (K, ...)
    idx_a: torch.Tensor  # (K,) int32
    idx_b: torch.Tensor  # (K,) int32
    mask: torch.Tensor  # (K,) bool


class ExtLinks(NamedTuple):
    """Padded relative-extrinsics drift factors between consecutive states'
    per-state T_SC blocks (relative-pose errors of variance sigma_c^2 dt)."""

    idx_a: torch.Tensor  # (Ke,) int32 older state's window slot
    idx_b: torch.Tensor  # (Ke,) int32 newer state's window slot
    cam: torch.Tensor  # (Ke,) int32
    sqrt_info: torch.Tensor  # (Ke, 6, 6)
    mask: torch.Tensor  # (Ke,) bool


class PosePriors(NamedTuple):
    state_idx: torch.Tensor  # (Kp,) int32
    r_meas: torch.Tensor  # (Kp, 3)
    q_meas: torch.Tensor  # (Kp, 4)
    sqrt_info: torch.Tensor  # (Kp, 6, 6)
    mask: torch.Tensor  # (Kp,) bool


class SbPriors(NamedTuple):
    state_idx: torch.Tensor  # (Ks,) int32
    sb_meas: torch.Tensor  # (Ks, 9)
    sqrt_info: torch.Tensor  # (Ks, 9, 9)
    mask: torch.Tensor  # (Ks,) bool


class MargPrior(NamedTuple):
    """Dense marginalization prior |e0 + J dchi|^2 / 2 in (H = J^T J,
    b0 = -J^T e0, c0 = |e0|^2) form over the dense parameter vector, with the
    first-estimate linearization points."""

    H: torch.Tensor  # (D, D)
    b0: torch.Tensor  # (D,)
    c0: torch.Tensor  # ()
    r_WS_lin: torch.Tensor  # (S, 3)
    q_WS_lin: torch.Tensor  # (S, 4)
    sb_lin: torch.Tensor  # (S, 9)
    r_SC_lin: torch.Tensor  # (C, 3)
    q_SC_lin: torch.Tensor  # (C, 4)
    valid: torch.Tensor  # () bool
    # per-state extrinsics first-estimate points (only when per-state)
    r_SC_t_lin: torch.Tensor = None  # (S, C, 3)
    q_SC_t_lin: torch.Tensor = None  # (S, C, 4)


class BaProblem(NamedTuple):
    """Everything one optimize call needs, fully padded."""

    states: WindowStates
    state_mask: torch.Tensor  # (S,) bool
    sb_mask: torch.Tensor  # (S,) bool: False once speed/bias was marginalized
    lm_mask: torch.Tensor  # (L,) bool
    obs: Observations
    imu_links: ImuLinks
    pose_priors: PosePriors
    sb_priors: SbPriors
    marg: MargPrior
    ext_links: ExtLinks = None  # only when cfg.extrinsics_per_state


def empty_problem(cfg: WindowConfig, dtype: torch.dtype = torch.float64, device=None) -> BaProblem:
    """An all-masked-out problem (identity quaternions everywhere)."""
    device = resolve_device(device)
    S, C, L, O = cfg.num_states, cfg.num_cameras, cfg.max_landmarks, cfg.max_observations
    K, D = cfg.max_imu_links, cfg.dense_dim
    Kp, Ks = cfg.max_pose_priors, cfg.max_sb_priors

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def idx(n, fill=0):
        return torch.full((n,), fill, dtype=torch.int32, device=device)

    def q_of(n):
        q = z(n, 4)
        q[:, 3].fill_(1.0)
        return q

    def eyes(n, k):
        return torch.eye(k, dtype=dtype, device=device).repeat(n, 1, 1)

    hp_W = z(L, 4)
    hp_W[:, 3].fill_(1.0)
    per_state = cfg.extrinsics_per_state
    Ke = cfg.ext_link_capacity

    def q_t():
        return q_of(S * C).reshape(S, C, 4) if per_state else None

    pre = PreintegratedImu(
        delta_q=q_of(K),
        C_integral=z(K, 3, 3),
        C_doubleintegral=z(K, 3, 3),
        acc_integral=z(K, 3),
        acc_doubleintegral=z(K, 3),
        dalpha_db_g=z(K, 3, 3),
        dv_db_g=z(K, 3, 3),
        dp_db_g=z(K, 3, 3),
        P_delta=eyes(K, 15),
        sqrt_info=eyes(K, 15),
        delta_t=z(K),
        sb_ref=z(K, 9),
    )
    return BaProblem(
        states=WindowStates(r_WS=z(S, 3), q_WS=q_of(S), speed_and_bias=z(S, 9),
                            r_SC=z(C, 3), q_SC=q_of(C), hp_W=hp_W,
                            r_SC_t=z(S, C, 3) if per_state else None, q_SC_t=q_t()),
        state_mask=z(S, dt=torch.bool),
        sb_mask=torch.ones(S, dtype=torch.bool, device=device),
        lm_mask=z(L, dt=torch.bool),
        obs=Observations(state_idx=idx(O), cam_idx=idx(O), lm_idx=idx(O), keypoint=z(O, 2),
                         sqrt_info=torch.ones(O, dtype=dtype, device=device), mask=z(O, dt=torch.bool)),
        imu_links=ImuLinks(pre=pre, idx_a=idx(K), idx_b=idx(K, 1), mask=z(K, dt=torch.bool)),
        pose_priors=PosePriors(state_idx=idx(Kp), r_meas=z(Kp, 3), q_meas=q_of(Kp),
                               sqrt_info=z(Kp, 6, 6), mask=z(Kp, dt=torch.bool)),
        sb_priors=SbPriors(state_idx=idx(Ks), sb_meas=z(Ks, 9), sqrt_info=z(Ks, 9, 9),
                           mask=z(Ks, dt=torch.bool)),
        marg=MargPrior(H=z(D, D), b0=z(D), c0=z(), r_WS_lin=z(S, 3), q_WS_lin=q_of(S),
                       sb_lin=z(S, 9), r_SC_lin=z(C, 3), q_SC_lin=q_of(C),
                       valid=z(dt=torch.bool), r_SC_t_lin=z(S, C, 3) if per_state else None,
                       q_SC_t_lin=q_t()),
        ext_links=ExtLinks(idx_a=idx(Ke), idx_b=idx(Ke, 1), cam=idx(Ke), sqrt_info=z(Ke, 6, 6),
                           mask=z(Ke, dt=torch.bool)) if per_state else None,
    )
