"""Carry the JAX package's state across as numpy arrays and plain values.

The port never imports okvis_tpu; a caller holding okvis_tpu objects passes
their numpy arrays and Python values here (the parity tests do so to give
both packages the same rig, configuration, IMU parameters, window,
estimator state and frames).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .cameras.ncamera import NCameraSystem
from .cameras.pinhole import CameraSpec
from .device import resolve_device
from .estimator.estimator import Estimator, ImuLinkRecord, LandmarkRecord, Observation, StateRecord, _host
from .frontend.detection import Keypoints
from .frontend.frame import FrameData, MultiFrame
from .frontend.frontend import FrontendConfig
from .imu.preintegration import ImuParams, PreintegratedImu
from .kinematics import SE3
from .solver.structure import (
    BaProblem, ExtLinks, ImuLinks, MargPrior, Observations, PosePriors, SbPriors, WindowConfig, WindowStates)


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


def frame_from_numpy(uv: np.ndarray, score: np.ndarray, mask: np.ndarray, descriptors: np.ndarray,
                     landmark_ids: np.ndarray, sizes=None, device=None,
                     dtype: torch.dtype = torch.float32) -> FrameData:
    """The port's FrameData from numpy arrays: (K, 2) uv and (K,) score in
    `dtype`, (K,) bool mask, (K, 16) descriptors as uint32 (the JAX
    package's) or int32 bit patterns (the port's), (K,) landmark ids (a
    copy is kept) and optional (K,) sizes. Host mirrors of uv and mask are
    set from the same arrays."""
    device = resolve_device(device)
    desc = np.ascontiguousarray(np.asarray(descriptors)).astype(np.uint32).view(np.int32)
    kps = Keypoints(uv=torch.from_numpy(np.array(uv)).to(device=device, dtype=dtype),
                    score=torch.from_numpy(np.array(score)).to(device=device, dtype=dtype),
                    mask=torch.from_numpy(np.array(mask, bool)).to(device))
    fd = FrameData(keypoints=kps, descriptors=torch.from_numpy(desc.copy()).to(device),
                   landmark_ids=np.array(landmark_ids, np.int64),
                   sizes=None if sizes is None else np.array(sizes))
    fd.set_host_mirrors(kps.uv.cpu().numpy(), np.array(mask, bool))
    return fd


def frame_to_numpy(fd) -> dict:
    """A FrameData of either package as frame_from_numpy's keyword
    arguments; descriptors as uint32."""
    desc = np.asarray(fd.descriptors.cpu() if isinstance(fd.descriptors, torch.Tensor) else fd.descriptors)
    host = lambda x: np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)  # noqa: E731
    return dict(uv=host(fd.keypoints.uv), score=host(fd.keypoints.score), mask=host(fd.keypoints.mask).astype(bool),
                descriptors=desc.view(np.uint32) if desc.dtype == np.int32 else desc.astype(np.uint32),
                landmark_ids=np.array(fd.landmark_ids, np.int64),
                sizes=None if fd.sizes is None else np.array(fd.sizes))


def multiframe_from_numpy(values: dict, device=None, dtype: torch.dtype = torch.float32) -> MultiFrame:
    """The port's MultiFrame from multiframe_to_numpy's output."""
    return MultiFrame(id=int(values["id"]), timestamp=float(values["timestamp"]),
                      frames=[frame_from_numpy(**f, device=device, dtype=dtype) for f in values["frames"]])


def multiframe_to_numpy(mf) -> dict:
    """A MultiFrame of either package as plain values and numpy arrays."""
    return dict(id=int(mf.id), timestamp=float(mf.timestamp), frames=[frame_to_numpy(f) for f in mf.frames])


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
    package's WindowConfig); an unknown key raises."""
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
                    pose_priors=PosePriors, sb_priors=SbPriors, marg=MargPrior, ext_links=ExtLinks),
    ImuLinks: dict(pre=PreintegratedImu),
}


def _tree_from_numpy(cls, values, device, dtype):
    fields = _fields_of(values)
    unported = sorted(k for k, v in fields.items() if k not in cls._fields and v is not None)
    if unported:
        raise NotImplementedError(f"problem_from_numpy: {cls.__name__} fields {unported} are not ported")
    out = {}
    for name in cls._fields:
        if fields.get(name) is None and name in cls._field_defaults:
            out[name] = None  # a mode's field the problem does not hold
            continue
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
    theirs. A mode's optional fields (per-state extrinsics) may be None."""
    return _tree_from_numpy(BaProblem, values, resolve_device(device), dtype)


def problem_to_numpy(problem: BaProblem) -> dict:
    """The inverse of problem_from_numpy: nested dicts of numpy arrays."""
    def conv(node):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            return node.detach().cpu().numpy()
        return {k: conv(v) for k, v in node._asdict().items()}

    return conv(problem)


# the estimator's float64 tables: slot-indexed variables, FEJ points, prior
_ESTIMATOR_ARRAYS = ("r_WS", "q_WS", "sb", "hp_W", "r_SC", "q_SC", "fej_r_WS", "fej_q_WS", "fej_sb", "fej_r_SC",
                     "fej_q_SC", "marg_H", "marg_b0", "r_SC_t", "q_SC_t", "fej_r_SC_t", "fej_q_SC_t")


def estimator_to_numpy(est) -> dict:
    """The host state of an Estimator of either package as plain values and
    numpy arrays: the slot tables and FEJ points, the marginal prior (read
    back if it is on a device), the state, landmark, observation, IMU-link
    and prior records, the per-state extrinsics tables and drift links, the
    free-slot lists, and the window sizes: the JAX package's checkpoint
    fields. A deferred propagation is committed first."""
    est.resolve_pending_prop()
    rec = dataclasses.asdict
    return dict(
        num_keyframes=int(est.num_keyframes),
        num_imu_frames=int(est.num_imu_frames),
        states=[rec(s) for s in est.states.values()],
        landmarks=[rec(lm) for lm in est.landmarks.values()],
        _lm_slot_to_id={int(k): int(v) for k, v in est._lm_slot_to_id.items()},
        _free_state_slots=[int(s) for s in est._free_state_slots],
        _free_lm_slots=[int(s) for s in est._free_lm_slots],
        observations=[dict(lm_id=o.lm_id, pose_id=o.pose_id, cam_idx=o.cam_idx, keypoint_idx=o.keypoint_idx,
                           keypoint=np.array(o.keypoint, np.float64), size=float(o.size))
                      for o in est.observations],
        imu_links=[dict(id_a=l.id_a, id_b=l.id_b, ts=np.array(l.ts, np.float64), gyro=np.array(l.gyro, np.float64),
                        acc=np.array(l.acc, np.float64), t0=float(l.t0), t1=float(l.t1)) for l in est.imu_links],
        pose_priors=[{k: (v if k == "pose_id" else _host(v)) for k, v in pr.items()} for pr in est.pose_priors],
        sb_priors=[{k: (v if k == "pose_id" else _host(v)) for k, v in pr.items()} for pr in est.sb_priors],
        ext_links=[dict(id_a=int(l["id_a"]), id_b=int(l["id_b"]), trans_var=float(l["trans_var"]),
                        rot_var=float(l["rot_var"])) for l in est.ext_links],
        fej_ext_t_frozen=np.array(est.fej_ext_t_frozen, bool),
        **{k: _host(getattr(est, k)) for k in _ESTIMATOR_ARRAYS},
        marg_c0=float(_host(est.marg_c0)),
        marg_valid=bool(est.marg_valid),
        fej_ext_frozen=bool(est.fej_ext_frozen),
    )


def estimator_from_numpy(values: dict, rig: NCameraSystem, imu_params: ImuParams, cfg: WindowConfig,
                         device=None, dtype: torch.dtype = torch.float64) -> Estimator:
    """The port's Estimator holding the host state of estimator_to_numpy's
    output (e.g. a JAX Estimator read mid-run): the same slots, ids, records,
    FEJ points and marginal prior, so both packages continue from the same
    window."""
    est = Estimator(rig, imu_params, values["num_keyframes"], values["num_imu_frames"], cfg=cfg,
                    dtype=dtype, device=device)
    load_estimator_state(est, values)
    return est


def load_estimator_state(est: Estimator, values: dict) -> None:
    """Set the port's Estimator to the host state of estimator_to_numpy's
    output: slots, ids, records, FEJ points and the marginal prior (as
    float64 numpy tables). The window sizes and table shapes must be the
    estimator's own, else ValueError. The observation-count map and the
    packed observation mirror are rebuilt from the records."""
    for k in ("num_keyframes", "num_imu_frames"):
        if values[k] != getattr(est, k):
            raise ValueError(f"load_estimator_state: {k} {values[k]} != the estimator's {getattr(est, k)}")
    for k in _ESTIMATOR_ARRAYS:
        if tuple(np.shape(values[k])) != tuple(getattr(est, k).shape):
            raise ValueError(f"load_estimator_state: {k} of shape {np.shape(values[k])}, "
                             f"the estimator's is {tuple(getattr(est, k).shape)}")
    est._pending_prop = None
    est.states = {s["id"]: StateRecord(**s) for s in values["states"]}
    est.landmarks = {lm["id"]: LandmarkRecord(**lm) for lm in values["landmarks"]}
    est._lm_slot_to_id = dict(values["_lm_slot_to_id"])
    est._free_state_slots = list(values["_free_state_slots"])
    est._free_lm_slots = list(values["_free_lm_slots"])
    est.observations = [Observation(**{**o, "keypoint": np.array(o["keypoint"], np.float64)})
                        for o in values["observations"]]
    est.imu_links = [ImuLinkRecord(**{k: np.array(v, np.float64) if isinstance(v, np.ndarray) else v
                                      for k, v in l.items()}) for l in values["imu_links"]]
    est.pose_priors = [{k: (v if k == "pose_id" else np.array(v, np.float64)) for k, v in pr.items()}
                       for pr in values["pose_priors"]]
    est.sb_priors = [{k: (v if k == "pose_id" else np.array(v, np.float64)) for k, v in pr.items()}
                     for pr in values["sb_priors"]]
    for k in _ESTIMATOR_ARRAYS:
        setattr(est, k, np.array(values[k], np.float64))
    est.marg_c0 = float(values["marg_c0"])
    est.marg_valid = bool(values["marg_valid"])
    est.fej_ext_frozen = bool(values["fej_ext_frozen"])
    est.ext_links = [dict(l) for l in values["ext_links"]]
    est.fej_ext_t_frozen = np.array(values["fej_ext_t_frozen"], bool)
    est._rebuild_obs_count()
    est._obs_cols.rebuild(est.observations, est.states, est.landmarks)
