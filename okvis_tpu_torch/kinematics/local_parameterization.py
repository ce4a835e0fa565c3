"""Named local parameterizations (port of
okvis_tpu.kinematics.local_parameterization): the reference's
PoseLocalParameterization family and HomogeneousPointLocalParameterization as
pure functions over tensors, batched over leading dimensions.

The subset variants select minimal coordinates out of the full SE(3) tangent
[dr(3); dalpha(3)]:
    Pose6d : [0,1,2,3,4,5]   full pose
    Pose3d : [3,4,5]         orientation only (translation frozen)
    Pose4d : [0,1,2,5]       translation + yaw (roll/pitch frozen)
    Pose2d : [3,4]           roll/pitch only
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import se3
from .se3 import SE3


def _pose_to_vec(T: SE3) -> torch.Tensor:
    """[r(3); q(xyzw)(4)] 7-vector, the reference parameter-block storage."""
    return torch.cat([T.r, T.q], dim=-1)


def _vec_to_pose(x: torch.Tensor) -> SE3:
    return SE3(r=x[..., :3], q=x[..., 3:7])


@dataclasses.dataclass(frozen=True)
class PoseParameterization:
    """SE(3) block parameterization with a minimal-coordinate subset:
    global_size = 7 ([r, q_xyzw]), local_size = len(selection)."""

    selection: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    name: str = "Pose6d"

    @property
    def global_size(self) -> int:
        return 7

    @property
    def local_size(self) -> int:
        return len(self.selection)

    def _expand(self, delta: torch.Tensor) -> torch.Tensor:
        """Scatter the minimal delta into the full 6-dim tangent."""
        full = delta.new_zeros(delta.shape[:-1] + (6,))
        full[..., list(self.selection)] = delta
        return full

    def plus(self, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """x [+] delta (left perturbation of the orientation, se3.oplus)."""
        return _pose_to_vec(se3.oplus(_vec_to_pose(x), self._expand(delta)))

    def minus(self, x: torch.Tensor, x_plus: torch.Tensor) -> torch.Tensor:
        """Minimal difference [dr; 2 vec(q1 q0^-1)] restricted to the subset."""
        return se3.minus(_vec_to_pose(x), _vec_to_pose(x_plus))[..., list(self.selection)]

    def plus_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 7, local): the subset columns of the full 7x6 oplus Jacobian."""
        return se3.oplus_jacobian(_vec_to_pose(x))[..., list(self.selection)]

    def lift_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        """(..., local, 7): the subset rows of the full 6x7 lift Jacobian."""
        return se3.lift_jacobian(_vec_to_pose(x))[..., list(self.selection), :]

    def tangent_mask(self) -> np.ndarray:
        """(6,) bool mask over [dr; dalpha]."""
        m = np.zeros(6, bool)
        m[list(self.selection)] = True
        return m

    def verify(self, x: torch.Tensor, eps: float = None, tol: float = None) -> bool:
        """Numeric self-check of plus/minus/plus_jacobian consistency (ref
        LocalParamizationAdditionalInterfaces::verify); the step and the
        tolerance follow x's dtype."""
        f64 = x.dtype == torch.float64
        eps = (1e-7 if f64 else 3e-4) if eps is None else eps
        tol = (1e-5 if f64 else 3e-3) if tol is None else tol
        n = self.local_size

        def close(a, b):  # np.allclose's rtol, as the JAX package checks
            return bool(torch.allclose(a, b, rtol=1e-5, atol=tol))

        if not close(self.plus(x, x.new_zeros(n)), x):
            return False
        d = 1e-4 * torch.arange(1.0, n + 1.0, dtype=x.dtype, device=x.device)
        if not close(self.minus(x, self.plus(x, d)), d):
            return False
        Jp = self.plus_jacobian(x)
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        Jn = torch.stack([(self.plus(x, eps * eye[i]) - self.plus(x, -eps * eye[i])) / (2 * eps)
                          for i in range(n)], dim=-1)
        if not close(Jp, Jn):
            return False
        return close(self.lift_jacobian(x) @ Jp, eye)


# the four named variants of the reference
PoseLocalParameterization = PoseParameterization((0, 1, 2, 3, 4, 5), "Pose6d")
PoseLocalParameterization3d = PoseParameterization((3, 4, 5), "Pose3d")
PoseLocalParameterization4d = PoseParameterization((0, 1, 2, 5), "Pose4d")
PoseLocalParameterization2d = PoseParameterization((3, 4), "Pose2d")


@dataclasses.dataclass(frozen=True)
class HomogeneousPointParameterization:
    """4-parameter homogeneous point with 3 minimal Euclidean dims: plus adds
    to the first three components, minus subtracts them."""

    name: str = "HomogeneousPoint"

    @property
    def global_size(self) -> int:
        return 4

    @property
    def local_size(self) -> int:
        return 3

    def plus(self, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        return torch.cat([x[..., :3] + delta, x[..., 3:]], dim=-1)

    def minus(self, x: torch.Tensor, x_plus: torch.Tensor) -> torch.Tensor:
        return x_plus[..., :3] - x[..., :3]

    def plus_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        J = x.new_zeros(x.shape[:-1] + (4, 3))
        J[..., :3, :] = torch.eye(3, dtype=x.dtype, device=x.device)
        return J

    def lift_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        J = x.new_zeros(x.shape[:-1] + (3, 4))
        J[..., :, :3] = torch.eye(3, dtype=x.dtype, device=x.device)
        return J


HomogeneousPointLocalParameterization = HomogeneousPointParameterization()
