"""Carry the JAX package's state across as numpy arrays and plain values.

The port never imports okvis_tpu; a caller holding okvis_tpu objects passes
their numpy arrays and Python values here (the parity tests do so to give
both packages the same rig, configuration, IMU parameters and window).
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
from .imu.preintegration import ImuParams, PreintegratedImu
from .kinematics import SE3
from .solver.structure import (
    BaProblem, ImuLinks, MargPrior, Observations, PosePriors, SbPriors, WindowConfig, WindowStates)


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


def _check_fields(cls, values, what: str) -> None:
    unknown = set(values) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"{what}: unknown fields {sorted(unknown)}")


def frontend_config_from_dict(values: dict) -> FrontendConfig:
    """FrontendConfig from plain values (e.g. dataclasses.asdict of the JAX
    package's FrontendConfig); an unknown key raises."""
    _check_fields(FrontendConfig, values, "frontend_config_from_dict")
    return FrontendConfig(**values)


def _fields_of(values) -> dict:
    """A NamedTuple's or a mapping's fields as a dict."""
    return values._asdict() if hasattr(values, "_asdict") else dict(values)


def _camera_spec(spec) -> CameraSpec:
    """A CameraSpec from a mapping (dataclasses.asdict's form) or any object
    with width, height and dist_type (the JAX package's CameraSpec)."""
    if isinstance(spec, dict):
        return CameraSpec(int(spec["width"]), int(spec["height"]), str(spec["dist_type"]))
    return CameraSpec(int(spec.width), int(spec.height), str(spec.dist_type))


def window_config_from_dict(values: dict) -> WindowConfig:
    """WindowConfig from plain values (e.g. dataclasses.asdict of the JAX
    package's WindowConfig); an unknown key raises, and so does
    extrinsics_per_state=True (not ported)."""
    _check_fields(WindowConfig, values, "window_config_from_dict")
    values = dict(values)
    values["camera_specs"] = tuple(_camera_spec(s) for s in values.get("camera_specs", ()))
    if "tier_divisors" in values:
        values["tier_divisors"] = tuple(int(d) for d in values["tier_divisors"])
    return WindowConfig(**values)


def imu_params_from_numpy(values, device=None, dtype: torch.dtype = torch.float64) -> ImuParams:
    """ImuParams from a mapping or NamedTuple of numpy arrays and plain values
    with ImuParams' field names (e.g. the JAX package's ImuParams)."""
    device = resolve_device(device)
    fields = _fields_of(values)
    return ImuParams(**{
        k: int(v) if k == "rate" else torch.from_numpy(np.array(v, np.float64)).to(device=device, dtype=dtype)
        for k, v in fields.items()})


# the BaProblem tree: which field of which NamedTuple is itself a NamedTuple
_SUBTREES = {
    BaProblem: dict(states=WindowStates, obs=Observations, imu_links=ImuLinks,
                    pose_priors=PosePriors, sb_priors=SbPriors, marg=MargPrior),
    ImuLinks: dict(pre=PreintegratedImu),
}


def _tree_from_numpy(cls, values, device, dtype):
    fields = _fields_of(values)
    unported = sorted(k for k, v in fields.items() if k not in cls._fields and v is not None)
    if unported:
        raise NotImplementedError(f"problem_from_numpy: {cls.__name__} fields {unported} are not ported")
    out = {}
    for name in cls._fields:
        sub = _SUBTREES.get(cls, {}).get(name)
        if sub is not None:
            out[name] = _tree_from_numpy(sub, fields[name], device, dtype)
            continue
        t = torch.from_numpy(np.array(fields[name]))  # a writable copy, 0-d kept
        out[name] = t.to(device=device, dtype=dtype) if t.is_floating_point() else t.to(device)
    return cls(**out)


def problem_from_numpy(values, device=None, dtype: torch.dtype = torch.float64) -> BaProblem:
    """BaProblem from a nested mapping or NamedTuple of numpy arrays with
    BaProblem's field names: the JAX package's BaProblem with numpy leaves
    (``jax.tree_util.tree_map(np.asarray, problem)``) or problem_to_numpy's
    output. Float arrays take `dtype`; int32 indices and bool masks keep
    theirs. Fields of modes the port does not hold (per-state extrinsics)
    must be None."""
    return _tree_from_numpy(BaProblem, values, resolve_device(device), dtype)


def problem_to_numpy(problem: BaProblem) -> dict:
    """The inverse of problem_from_numpy: nested dicts of numpy arrays."""
    def conv(node):
        if isinstance(node, torch.Tensor):
            return node.detach().cpu().numpy()
        return {k: conv(v) for k, v in node._asdict().items()}

    return conv(problem)
