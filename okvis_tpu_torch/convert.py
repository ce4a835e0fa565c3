"""Carry the JAX package's state across as numpy arrays and plain values.

The port never imports okvis_tpu; a caller holding okvis_tpu objects passes
their numpy arrays and Python values here (the parity tests do so to give
both packages the same rig and configuration).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .cameras.ncamera import NCameraSystem
from .cameras.pinhole import CameraSpec
from .device import resolve_device
from .frontend.frontend import FrontendConfig
from .kinematics import SE3


def rig_from_numpy(
    specs: Sequence,  # per camera: (width, height, dist_type)
    T_SC_r: np.ndarray,  # (N, 3)
    T_SC_q: np.ndarray,  # (N, 4) xyzw
    intrinsics: Sequence[np.ndarray],  # per camera (4+K_i,)
    device=None,
    dtype: torch.dtype = torch.float64,
    compute_overlaps: bool = True,
) -> NCameraSystem:
    """The port's NCameraSystem from numpy arrays and plain values."""
    device = resolve_device(device)

    def t(a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, dtype=np.float64), device=device).to(dtype)

    rig = NCameraSystem(
        specs=tuple(CameraSpec(int(w), int(h), str(t)) for w, h, t in specs),
        T_SC=SE3(r=t(T_SC_r), q=t(T_SC_q)),
        intrinsics=[t(i) for i in intrinsics],
    )
    if compute_overlaps:
        rig.compute_overlaps()
    return rig


def rig_to_numpy(rig: NCameraSystem) -> dict:
    """The inverse of rig_from_numpy: keyword arguments that rebuild the rig."""
    return dict(
        specs=[(s.width, s.height, s.dist_type) for s in rig.specs],
        T_SC_r=rig.T_SC.r.cpu().numpy(),
        T_SC_q=rig.T_SC.q.cpu().numpy(),
        intrinsics=[i.cpu().numpy() for i in rig.intrinsics],
    )


def frontend_config_from_dict(values: dict) -> FrontendConfig:
    """FrontendConfig from plain values (e.g. dataclasses.asdict of the JAX
    package's FrontendConfig); an unknown key raises."""
    names = {f.name for f in dataclasses.fields(FrontendConfig)}
    unknown = set(values) - names
    if unknown:
        raise ValueError(f"frontend_config_from_dict: unknown fields {sorted(unknown)}")
    return FrontendConfig(**values)
