"""Sliding-window estimator: host bookkeeping + device programs (port of
okvis_tpu.estimator.estimator).

The reference okvis::Estimator's mutable problem graph becomes:

- host (numpy/python): id <-> slot maps, observation/link/prior tables,
  keyframe flags, landmark records, FEJ freeze flags: O(window) float64
  bookkeeping, the same decisions as the JAX package's.
- device (torch on the estimator's device, the CUDA card by default):
  batched re-preintegration of all IMU links, the LM/Schur optimize step
  (solver.optimize_window), and the FEJ marginalization step
  (marginalization.marginalize_system on an evaluate() of the absorbed
  factors). Each is a cached callable under the JAX package's program-cache
  keys, so a captured form (a CUDA graph) can replace one without touching
  the host logic: on the card the preintegration is a PreintegrationGraph
  and each optimize variant an OptimizeGraph.

Window semantics follow the reference:
- add_states: the first frame initializes from gravity with a position+yaw
  pose prior (info 1e8) and a speed/bias prior; later frames propagate the
  previous state and add an IMU link factor.
- apply_marginalization_strategy: keep the newest num_imu_frames states;
  older frames lose their speed/bias (absorbed with the IMU link into the
  prior); non-keyframes and overflow keyframes lose their pose; landmark
  triage (delete / ignore-observation / marginalize) follows the
  reference's hasNewObservations / obsCount rules.

Per-state extrinsics (cfg.extrinsics_per_state, the reference's per-state
T_SCi blocks): every state gets its own T_SC block per camera, initialized
from the previous state's, linked to it by a relative-pose drift factor of
variance sigma_c^2 dt, the first state's blocks anchored by a prior through
the marginal-prior mechanism; blocks of removed frames are marginalized with
their pose and their drift links absorbed into the prior.

enable_distributed runs every optimize as the sharded BA of
okvis_tpu_torch.parallel over a mesh of devices (n shards may share one
card). save_checkpoint / load_checkpoint write and read the port's own
file: the host state of convert.estimator_to_numpy plus the window's
multiframe keypoint tables.

Host syncs: add_states' propagation fetch (unless deferred), one fetch at
the end of optimize (one device-to-host copy of every pulled table), one
read of the final cost per chunk of the wall-clock budget, the three of
marginalize_system's eigh calls, and every copy of a host array to the card
(each waits for the stream). syncstats counts them all (`marg_eigh`,
`upload`); in a traced pipeline frame each is a `sync.<tag>` span.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
import pickle
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kinematics as kin
from ..cameras.ncamera import NCameraSystem
from ..device import resolve_device
from ..imu.preintegration import ImuParams, PreintegrationGraph, init_pose_from_imu, preintegrate, propagate
from ..kinematics.se3 import SE3
from ..solver import (
    BaProblem,
    ExtLinks,
    ImuLinks,
    MargPrior,
    Observations,
    OptimizeGraph,
    PosePriors,
    SbPriors,
    SolveDiagnostics,
    WindowConfig,
    WindowStates,
    empty_problem,
    optimize_window,
)
from ..solver.assemble import evaluate
from ..solver.optimize import _landmark_quality, dense_dim_mask, useful_iterations
from ..utils import capture, syncstats, timing
from ..utils.ids import IdProvider
from ..utils.timing import Timer, Timing
from .marginalization import marginalize_system

# opt-in consistency checks for incrementally maintained host bookkeeping
_DEBUG_CHECKS = os.environ.get("OKVIS_DEBUG_CHECKS", "") == "1"


def _tree_map(fn, tree):
    """fn applied to every leaf of a nested tuple/list/dict/NamedTuple."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def device_get(tree):
    """Tensors of a nested tuple/list/dict/NamedTuple as numpy arrays, with
    one wait for the card: every device tensor is copied into pinned host
    memory without blocking, then the stream is synchronised once."""
    devices = []

    def stage(x):
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x.detach(), non_blocking=True)
            devices.append(x.device)
            return host
        return x

    staged = _tree_map(stage, tree)
    if devices:
        torch.cuda.current_stream(devices[0]).synchronize()
    return _tree_map(lambda x: x.detach().numpy() if isinstance(x, torch.Tensor) else x, staged)


def _host(x) -> np.ndarray:
    """A tensor or array-like as a float64 numpy copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64).numpy().copy()
    return np.array(x, np.float64)


class WindowFullError(RuntimeError):
    """add_states found no free state slot: the window is full until
    apply_marginalization_strategy frees one. The pipeline drops the frame
    on this refusal alone; any other error (a failed launch, an exhausted
    card) propagates."""


# the first entry of a checkpoint file written by save_checkpoint
CHECKPOINT_FORMAT = "okvis_tpu_torch.Estimator checkpoint 2"


@dataclasses.dataclass
class StateRecord:
    id: int
    timestamp: float  # seconds (host keeps float64 seconds; ns at the pipeline)
    slot: int
    is_keyframe: bool
    sb_active: bool = True  # False once speed/bias marginalized
    fej_frozen: bool = False  # linearization point frozen in the prior


@dataclasses.dataclass
class LandmarkRecord:
    id: int
    slot: int
    initialized: bool
    quality: float = 0.0


@dataclasses.dataclass(slots=True)
class Observation:
    lm_id: int
    pose_id: int
    cam_idx: int
    keypoint_idx: int
    keypoint: np.ndarray  # (2,)
    size: float  # keypoint size -> information 64/size^2 (implementation/Estimator.hpp:62-66)
    row: int = -1  # row in the estimator's columnar mirror (_ObsColumns)


class _ObsColumns:
    """Packed numpy mirror of the observation list, maintained incrementally.

    State and landmark slots are stable for the lifetime of an observation,
    so every column is written once at add time; building the device table
    is then numpy gathers over the live rows. Removal paths mark rows dead
    via Observation.row; the arrays compact (rows re-stamped) when dead rows
    accumulate. With OKVIS_DEBUG_CHECKS=1 the estimator cross-checks the
    gathered table against a fresh rebuild."""

    __slots__ = ("cap", "n", "state_slot", "cam", "lm_slot", "kp", "w", "live")

    def __init__(self, capacity: int):
        self.cap = capacity
        self.n = 0
        self.state_slot = np.zeros(capacity, np.int32)
        self.cam = np.zeros(capacity, np.int32)
        self.lm_slot = np.zeros(capacity, np.int32)
        self.kp = np.zeros((capacity, 2))
        self.w = np.ones(capacity)
        self.live = np.zeros(capacity, bool)

    def append(self, state_slot: int, cam: int, lm_slot: int, kp, w: float) -> int:
        i = self.n
        self.state_slot[i] = state_slot
        self.cam[i] = cam
        self.lm_slot[i] = lm_slot
        self.kp[i] = kp
        self.w[i] = w
        self.live[i] = True
        self.n = i + 1
        return i

    def kill(self, row: int) -> None:
        self.live[row] = False

    def live_rows(self) -> np.ndarray:
        return np.nonzero(self.live[: self.n])[0]

    def rebuild(self, observations, states, landmarks) -> None:
        """Re-stamp every row from scratch (state carried across, compaction)."""
        self.n = 0
        self.live[:] = False
        for o in observations:
            o.row = self.append(
                states[o.pose_id].slot, o.cam_idx, landmarks[o.lm_id].slot, o.keypoint, 8.0 / o.size)


@dataclasses.dataclass
class ImuLinkRecord:
    id_a: int
    id_b: int
    ts: np.ndarray  # (P,) seconds, padded
    gyro: np.ndarray  # (P, 3)
    acc: np.ndarray  # (P, 3)
    t0: float
    t1: float


class Estimator:
    """Host-side sliding-window VIO back end (the reference's
    VioBackendInterface) on the port's device programs.

    `device` defaults to the CUDA card and raises without one; pass
    device="cpu" to run on the CPU. `dtype` is the device programs' float
    type; the host tables stay float64."""

    def __init__(
        self,
        rig: NCameraSystem,
        imu_params: ImuParams,
        num_keyframes: int = 5,
        num_imu_frames: int = 3,
        cfg: Optional[WindowConfig] = None,
        dtype: torch.dtype = torch.float64,
        estimate_extrinsics: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.rig = rig
        self.dtype = dtype
        self.imu_params = ImuParams(*(
            x.to(device=self.device, dtype=dtype) if isinstance(x, torch.Tensor) else x
            for x in imu_params))
        self.num_keyframes = num_keyframes
        self.num_imu_frames = num_imu_frames
        S = num_keyframes + num_imu_frames + 1  # +1: new frame before marginalization
        self.cfg = cfg or WindowConfig(
            num_states=S,
            num_cameras=rig.num_cameras,
            camera_specs=tuple(rig.specs),
            max_imu_links=S - 1,
            max_pose_priors=2,
            max_sb_priors=2,
            estimate_extrinsics=estimate_extrinsics,
        )
        self.intrinsics = [i.to(device=self.device, dtype=dtype) for i in rig.intrinsics]

        # host state
        self.states: Dict[int, StateRecord] = {}  # insertion-ordered by time
        self.landmarks: Dict[int, LandmarkRecord] = {}
        self._lm_slot_to_id: Dict[int, int] = {}
        self._free_state_slots = list(range(self.cfg.num_states))[::-1]
        self._free_lm_slots = list(range(self.cfg.max_landmarks))[::-1]
        self.observations: List[Observation] = []
        # packed numpy mirror (4x capacity: dead rows accumulate between
        # compactions; see _ObsColumns)
        self._obs_cols = _ObsColumns(4 * self.cfg.max_observations)
        # incrementally maintained lm_id -> live observation count; the
        # frontend reads it every frame
        self.obs_count: Dict[int, int] = {}
        self.imu_links: List[ImuLinkRecord] = []
        self.pose_priors: List[dict] = []
        self.sb_priors: List[dict] = []
        # frame-id -> MultiFrame (the reference's multiFramePtrMap_)
        self.multiframes: Dict[int, object] = {}

        # numpy mirrors of window variables (slot-indexed)
        S, L = self.cfg.num_states, self.cfg.max_landmarks
        self.r_WS = np.zeros((S, 3))
        self.q_WS = np.tile([0.0, 0, 0, 1], (S, 1))
        self.sb = np.zeros((S, 9))
        self.hp_W = np.tile([0.0, 0, 0, 1], (L, 1))
        self.r_SC = _host(rig.T_SC.r)
        self.q_SC = _host(rig.T_SC.q)
        # per-state (temporally varying) extrinsics tables and drift links
        self.r_SC_t = np.tile(self.r_SC[None], (S, 1, 1))
        self.q_SC_t = np.tile(self.q_SC[None], (S, 1, 1))
        self.ext_links: List[dict] = []  # {id_a, id_b, trans_var, rot_var}

        # FEJ linearization points + marginal prior (numpy mirrors; the prior
        # stays on the device after a marginalization)
        self.fej_r_WS = self.r_WS.copy()
        self.fej_q_WS = self.q_WS.copy()
        self.fej_sb = self.sb.copy()
        # extrinsics FEJ: frozen at the first marginalization when online
        # calibration is active (otherwise the ext dims are masked out of
        # the prior and the point is irrelevant)
        self.fej_r_SC = self.r_SC.copy()
        self.fej_q_SC = self.q_SC.copy()
        self.fej_ext_frozen = False
        self.fej_r_SC_t = self.r_SC_t.copy()
        self.fej_q_SC_t = self.q_SC_t.copy()
        self.fej_ext_t_frozen = np.zeros(S, bool)  # per state slot
        D = self.cfg.dense_dim
        self.marg_H = np.zeros((D, D))
        self.marg_b0 = np.zeros(D)
        self.marg_c0 = 0.0
        self.marg_valid = False

        # the device programs, keyed as the JAX package's _jit_cache
        self._jit_cache: Dict[object, object] = {}
        self._mesh = None  # set by enable_distributed()
        self._n_shards = 1
        # deferred add_states propagation: (slot, T_WS device, sb device) not
        # yet committed to the numpy tables; fetched together with the next
        # association fetch (fetch_with_pending), so add_states itself never
        # waits for the card
        self._pending_prop: Optional[Tuple[int, SE3, torch.Tensor]] = None

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------
    def _t(self, x) -> torch.Tensor:
        """A float array, or the device-resident prior, as a tensor of the
        estimator's dtype on its device. A copy from the host waits for the
        card's stream (syncstats `upload`)."""
        on_device = isinstance(x, torch.Tensor) and x.device.type == self.device.type
        with contextlib.nullcontext() if on_device else syncstats.sync("upload"):
            if isinstance(x, torch.Tensor):
                return x.to(device=self.device, dtype=self.dtype)
            return torch.from_numpy(np.asarray(x, np.float64)).to(device=self.device, dtype=self.dtype)

    def _i(self, x) -> torch.Tensor:
        """An int or bool array as a tensor on the device (its own dtype)."""
        with syncstats.sync("upload"):
            return torch.from_numpy(np.asarray(x)).to(self.device)

    def _materialize_prior(self) -> None:
        """Bring a device-resident marginal prior back as float64 numpy
        copies (H, b0) and a float (c0)."""
        if isinstance(self.marg_H, torch.Tensor):
            self.marg_H = _host(self.marg_H)
            self.marg_b0 = _host(self.marg_b0)
            self.marg_c0 = float(_host(self.marg_c0))

    def add_extrinsics_prior(self, sigma_translation: float, sigma_orientation: float) -> None:
        """Absolute extrinsics prior for online calibration (the reference's
        PoseError on T_SC with sigma_absolute_*, Estimator.cpp:287-307),
        expressed through the marginal-prior mechanism: information on the
        extrinsic dims around the initial T_SC linearization points."""
        assert self.cfg.estimate_extrinsics, "enable estimate_extrinsics first"
        self._materialize_prior()
        S, C = self.cfg.num_states, self.cfg.num_cameras
        info = np.concatenate(
            [np.full(3, 1.0 / sigma_translation**2), np.full(3, 1.0 / sigma_orientation**2)])
        for c in range(C):
            i0 = S * 15 + c * 6
            self.marg_H[i0: i0 + 6, i0: i0 + 6] += np.diag(info)
        self.fej_r_SC = self.r_SC.copy()
        self.fej_q_SC = self.q_SC.copy()
        self.fej_ext_frozen = True
        self.marg_valid = True

    # ------------------------------------------------------------------
    # device programs (built lazily, one per config)
    # ------------------------------------------------------------------
    def _tier_cfg(self, cfg: WindowConfig, LO: Optional[Tuple[int, int]]) -> WindowConfig:
        if LO is None:
            return cfg
        return dataclasses.replace(cfg, max_landmarks=LO[0], max_observations=LO[1])

    def _optimize_fn(self, max_iterations: Optional[int] = None, LO: Optional[Tuple[int, int]] = None):
        """The optimize step; one variant per (iteration count, capacity
        tier). The reference aborts Ceres mid-solve on a wall-clock limit;
        here the time-limit knob selects a shorter-iteration variant or runs
        the chunked contract of _optimize_deadline. `LO` (max_landmarks,
        max_observations) selects a reduced capacity tier. On the card a
        single-device variant is an OptimizeGraph (eager on a shape's first
        call, recorded on its second, replayed after); on the CPU the eager
        call; over a mesh the sharded step."""
        key = ("opt", max_iterations, self._mesh is not None, LO)
        if key not in self._jit_cache:
            cfg = self._tier_cfg(self.cfg if max_iterations is None else dataclasses.replace(
                self.cfg, max_iterations=max_iterations), LO)
            if self._mesh is not None:
                fn = self._make_sharded_fn(cfg)
            elif self.device.type == "cuda":
                fn = OptimizeGraph(cfg, self.imu_params, self.intrinsics)
            else:
                fn = functools.partial(optimize_window, cfg, self.imu_params, self.intrinsics)
            self._jit_cache[key] = fn
        return self._jit_cache[key]

    def _optimize_fn_for_problem(self, problem, max_iterations: Optional[int] = None):
        """The variant matching `problem`'s (possibly tiered) shapes."""
        L, O = int(problem.lm_mask.shape[0]), int(problem.obs.mask.shape[0])
        LO = None if (L, O) == (self.cfg.max_landmarks, self.cfg.max_observations) else (L, O)
        return self._optimize_fn(max_iterations, LO=LO)

    def _optimize_continue_fn(self, chunk_iters: int = 1, LO: Optional[Tuple[int, int]] = None):
        """Continuation chunk: re-enter the trust-region loop at the current
        iterate with a warm-started damping (optimize_window's trust0). Used
        by the wall-clock budget contract."""
        key = ("opt_cont", chunk_iters, LO)
        if key not in self._jit_cache:
            cfg = dataclasses.replace(self.cfg, max_iterations=chunk_iters)
            self._jit_cache[key] = functools.partial(
                optimize_window, self._tier_cfg(cfg, LO), self.imu_params, self.intrinsics)
        return self._jit_cache[key]

    def _select_tier(self):
        """Pick the smallest capacity tier that holds the live problem.

        Returns None (full capacity) or a dict with the tier sizes, the
        active landmark slots (compact order) and the slot->compact remap.
        Tiering is identical math (every factor and mask is kept, only the
        padding shrinks), so selection is purely a speed decision."""
        cfg = self.cfg
        if not cfg.capacity_tiers or self._mesh is not None:
            return None
        if os.environ.get("OKVIS_CAPACITY_TIERS", "") in ("0", "marg"):
            return None  # debug kill-switch ("marg" = marg-tier only)
        n_obs = int(self._obs_cols.live[: self._obs_cols.n].sum())
        n_lm = len(self.landmarks)
        L, O = cfg.max_landmarks, cfg.max_observations
        best = None
        if os.environ.get("OKVIS_CAPACITY_TIERS") == "fullsize":
            best = (L, O)  # debug: compaction/remap at unchanged padding
        else:
            for d in cfg.tier_divisors:
                if L % d or O % d:
                    continue
                if n_lm <= L // d and n_obs <= O // d:
                    best = (L // d, O // d)
                    break  # divisors largest-first = smallest tier first
        if best is None:
            return None
        slots = np.fromiter((lm.slot for lm in self.landmarks.values()), np.int64, n_lm)
        remap = np.zeros(L, np.int32)
        remap[slots] = np.arange(n_lm, dtype=np.int32)
        return {"L": best[0], "O": best[1], "slots": slots, "remap": remap}

    def _optimize_deadline(self, problem, time_limit: float, min_iterations: int, max_iterations: int,
                           LO: Optional[Tuple[int, int]] = None):
        """Wall-clock optimization budget (the reference's CeresIterationCallback:
        stop when elapsed > timeLimit once >= minIterations ran): run the
        min-iteration program, then, while the elapsed time plus the
        (EMA-estimated) cost of one more 1-iteration continuation chunk fits
        the budget, top up. Each chunk re-enters the loop at the current
        device iterate with the carried damping (the previous chunk's
        final_lambda tensor). One sync a chunk: the read of its final cost."""
        t0 = time.perf_counter()
        fn = self._optimize_fn(min_iterations, LO=LO)
        states, diag = fn(problem)
        if capture.enabled:
            capture.record("optimize", fn, problem)
            capture.record_output("optimize", (states, diag))
        with syncstats.sync("optimize_deadline_sync"):
            diag.final_cost.cpu()  # the deadline needs real elapsed time
        iters = min_iterations
        initial_cost = diag.initial_cost
        hists, accs = [diag.cost_history], [diag.accepted]
        chunk_cost = None
        cont = self._optimize_continue_fn(1, LO=LO)
        while iters < max_iterations:
            elapsed = time.perf_counter() - t0
            # first prediction: one blocking round trip (the min program's
            # elapsed) upper-bounds a 1-iteration chunk
            predicted = chunk_cost if chunk_cost is not None else elapsed
            if elapsed + predicted > time_limit:
                break
            tc = time.perf_counter()
            states, diag = cont(problem._replace(states=states), diag.final_lambda)
            with syncstats.sync("optimize_deadline_sync"):
                diag.final_cost.cpu()
            dt = time.perf_counter() - tc
            chunk_cost = dt if chunk_cost is None else 0.5 * chunk_cost + 0.5 * dt
            iters += 1
            hists.append(diag.cost_history)
            accs.append(diag.accepted)
        if len(hists) > 1:
            diag = diag._replace(cost_history=torch.cat(hists), accepted=torch.cat(accs), initial_cost=initial_cost)
        return states, diag

    def enable_distributed(self, mesh=None, n_devices: Optional[int] = None) -> None:
        """Run every optimize() as the sharded BA over a device mesh: the
        landmark and observation tables split over the mesh's shards, the
        dense system summed over them (okvis_tpu_torch.parallel). `mesh` is
        a parallel.Mesh (several shards may share one card); without one,
        n_devices distinct cards (parallel.make_mesh), or n_devices CPU
        shards when the estimator runs on the CPU. The mesh runs in this
        process. Requires max_landmarks and max_observations divisible by
        the mesh size. The sharded step carries no capacity tiers and no
        wall-clock budget, as in the JAX package."""
        from ..parallel import make_mesh

        if mesh is None:
            mesh = make_mesh(devices=[self.device] * (n_devices or 1)) if self.device.type == "cpu" \
                else make_mesh(n_devices)
        if mesh.process_axis is not None:
            raise ValueError("Estimator.enable_distributed: the mesh must lie in this process")
        self._mesh = mesh
        self._n_shards = mesh.size
        if self.cfg.max_landmarks % self._n_shards or self.cfg.max_observations % self._n_shards:
            raise ValueError(
                f"landmark/observation capacities {self.cfg.max_landmarks}/{self.cfg.max_observations} "
                f"not divisible by mesh size {self._n_shards}")
        # drop single-device variants; they are rebuilt sharded
        for k in list(self._jit_cache):
            if isinstance(k, tuple) and k[0] == "opt":
                del self._jit_cache[k]
        # landmark slots must spread across the shard blocks (shard_problem
        # gives slot l to shard l // (L/n), and each shard's observation
        # block holds only its landmarks' observations): hand out free slots
        # round-robin over the blocks instead of in order
        self._rebalance_free_lm_slots()

    def _rebalance_free_lm_slots(self) -> None:
        """Order the free landmark slots so that consecutive pops cycle
        through the shard blocks (keeps each shard's observation load
        balanced)."""
        n, Ls = self._n_shards, self.cfg.max_landmarks // self._n_shards
        free = set(self._free_lm_slots)
        rr = [b * Ls + i for i in range(Ls) for b in range(n)]
        self._free_lm_slots = [s for s in rr if s in free][::-1]

    def _make_sharded_fn(self, cfg: WindowConfig):
        from ..parallel import make_sharded_optimizer, shard_problem

        axis = tuple(self._mesh.axis_names)
        opt = make_sharded_optimizer(cfg, self.imu_params, self.intrinsics, self._mesh,
                                     axis=axis[0] if len(axis) == 1 else axis)

        def run(problem: BaProblem):
            states, (cost, hist, acc, lam) = opt(shard_problem(problem, self._n_shards))
            # no landmark_quality: optimize() runs its separate pass
            return _tree_map(lambda x: None if x is None else x.to(self.device), states), SolveDiagnostics(
                cost_history=hist, accepted=acc, final_cost=cost, final_lambda=lam)

        return run

    @property
    def _preintegrate_fn(self):
        """Full-mode preintegrate, batched over the links by itself (no
        vmap): on the card a PreintegrationGraph, the counterpart of the JAX
        package's jitted program (one graph per device, dtype and shape); on
        the CPU the eager call."""
        if "pre" not in self._jit_cache:
            self._jit_cache["pre"] = (PreintegrationGraph(self.imu_params) if self.device.type == "cuda" else
                                      functools.partial(preintegrate, self.imu_params))
        return self._jit_cache["pre"]

    @property
    def _propagate_fn(self):
        if "prop" not in self._jit_cache:
            self._jit_cache["prop"] = functools.partial(propagate, self.imu_params)
        return self._jit_cache["prop"]

    def _marginalize_fn_LO(self, LO: Optional[Tuple[int, int]] = None):
        """The marginalization step; one variant per capacity tier (the
        absorbed factor set is a few landmarks and their observations)."""
        key = ("marg", LO)
        if key not in self._jit_cache:
            cfg = self._tier_cfg(self.cfg, LO)

            def marg_step(problem, marg_dense, keep_dense, marg_lm):
                eqs = evaluate(cfg, self.imu_params, self.intrinsics, problem, problem.states)
                return marginalize_system(cfg, eqs, marg_dense, keep_dense, marg_lm, 2.0 * eqs.cost)

            self._jit_cache[key] = marg_step
        return self._jit_cache[key]

    def _select_marg_tier(self, absorb_obs, marg_lm_slots):
        """Capacity tier for the marginalization launch: the smallest (L, O)
        holding the absorbed observations and every referenced landmark
        slot. The same exact-math compaction as _select_tier."""
        cfg = self.cfg
        if not cfg.capacity_tiers or self._mesh is not None:
            return None
        if os.environ.get("OKVIS_CAPACITY_TIERS", "") in ("0", "opt"):
            return None  # debug kill-switch ("opt" = optimize-tier only)
        slots = sorted(set(marg_lm_slots) | {s for _o, s in absorb_obs})
        n_obs = len(absorb_obs)
        L, O = cfg.max_landmarks, cfg.max_observations
        best = None
        for d in cfg.tier_divisors:
            if L % d or O % d:
                continue
            if len(slots) <= L // d and n_obs <= O // d:
                best = (L // d, O // d)
                break
        if best is None:
            return None
        slots = np.asarray(slots, np.int64)
        remap = np.zeros(L, np.int32)
        remap[slots] = np.arange(slots.size, dtype=np.int32)
        return {"L": best[0], "O": best[1], "slots": slots, "remap": remap}

    @property
    def _landmark_quality_fn(self):
        if "lmq" not in self._jit_cache:

            def lm_quality(problem):
                eqs = evaluate(self.cfg, self.imu_params, self.intrinsics, problem, problem.states)
                return _landmark_quality(eqs.H_ll)

            self._jit_cache["lmq"] = lm_quality
        return self._jit_cache["lmq"]

    # ------------------------------------------------------------------
    # state management (the reference's Estimator::addStates)
    # ------------------------------------------------------------------
    def add_states(
        self,
        timestamp: float,
        imu_ts: np.ndarray,
        imu_gyro: np.ndarray,
        imu_acc: np.ndarray,
        as_keyframe: bool = False,
        frame_id: Optional[int] = None,
        defer_fetch: bool = False,
    ) -> int:
        """Create a new window state at `timestamp` from IMU propagation.

        imu_* must cover [previous state time, timestamp] (the pipeline
        slices with a small overlap). Link timestamps go to the device
        rebased to the link's start time, so float32 keeps their resolution.

        defer_fetch: leave the propagated pose/speed-bias on the device
        (fetched by the next fetch_with_pending / resolve_pending_prop
        instead of waiting here); the numpy tables for this state are stale
        until then."""
        self.resolve_pending_prop()
        state_id = frame_id if frame_id is not None else IdProvider.new_id()
        if not self.states:
            T_WS = init_pose_from_imu(self._t(np.asarray(imu_acc).mean(axis=0)))
            sb = np.zeros(9)
            sb[6:9] = _host(self.imu_params.a0)
        else:
            last = self._last_state()
            T_prev = SE3(r=self._t(self.r_WS[last.slot]), q=self._t(self.q_WS[last.slot]))
            ts_p, gy_p, ac_p = self._pad_imu(imu_ts, imu_gyro, imu_acc, self.cfg.imu_samples)
            prop_args = (
                T_prev,
                self._t(self.sb[last.slot]),
                self._t(ts_p - last.timestamp),
                self._t(gy_p),
                self._t(ac_p),
                self._t(0.0),
                self._t(float(timestamp) - last.timestamp),
            )
            T_WS, sb_j = self._propagate_fn(*prop_args)
            if capture.enabled:
                capture.record("propagate", self._propagate_fn, *prop_args)
                capture.record_output("propagate", (T_WS, sb_j))
            sb = None if defer_fetch else sb_j

        if not self._free_state_slots:
            raise WindowFullError("window full — call apply_marginalization_strategy")
        slot = self._free_state_slots.pop()
        rec = StateRecord(id=state_id, timestamp=float(timestamp), slot=slot, is_keyframe=as_keyframe)
        self.states[state_id] = rec
        if sb is None:
            # device-resident until the next fused fetch; numpy rows stale
            self._pending_prop = (slot, T_WS, sb_j)
        else:
            with syncstats.sync("propagate_fetch") if len(self.states) > 1 else contextlib.nullcontext():
                r, q, sbv = device_get((T_WS.r, T_WS.q, sb))
            self.r_WS[slot] = r
            self.q_WS[slot] = q
            self.sb[slot] = sbv
            sb = self.sb[slot].copy()

        per_state = self.cfg.extrinsics_per_state
        if per_state:
            # a fresh per-state extrinsics block for this state, from the
            # newest estimate (the reference starts at the nominal T_SC; the
            # running estimate is equivalent under the drift link)
            src = ([s for s in self.states.values() if s.id != state_id][-1].slot
                   if len(self.states) > 1 else None)
            self.r_SC_t[slot] = self.r_SC.copy() if src is None else self.r_SC_t[src].copy()
            self.q_SC_t[slot] = self.q_SC.copy() if src is None else self.q_SC_t[src].copy()
            self.fej_r_SC_t[slot] = self.r_SC_t[slot].copy()
            self.fej_q_SC_t[slot] = self.q_SC_t[slot].copy()
            self.fej_ext_t_frozen[slot] = False

        if len(self.states) == 1:
            # first frame: position+yaw pose prior (info 1e8) + speed/bias
            # prior (Estimator.cpp:238-285)
            sqrt_info_pose = np.diag([1e4, 1e4, 1e4, 0.0, 0.0, 1e4])
            self.pose_priors.append(dict(
                pose_id=state_id, r=self.r_WS[slot].copy(), q=self.q_WS[slot].copy(),
                sqrt_info=sqrt_info_pose))
            sbg = float(_host(self.imu_params.sigma_bg))
            sba = float(_host(self.imu_params.sigma_ba))
            sqrt_info_sb = np.diag([1.0] * 3 + [1.0 / sbg] * 3 + [1.0 / sba] * 3)
            self.sb_priors.append(dict(pose_id=state_id, sb=sb.copy(), sqrt_info=sqrt_info_sb))
            if per_state:
                # first-frame extrinsics anchoring (Estimator.cpp:287-315): an
                # absolute prior when sigma_absolute_* > 0, else a stiff gauge
                # prior, both through the marginal prior around the FEJ point
                sig_t = self.cfg.sigma_absolute_translation
                sig_r = self.cfg.sigma_absolute_orientation
                if sig_t > 1e-8 and sig_r > 1e-8:
                    info = np.concatenate([np.full(3, 1.0 / sig_t**2), np.full(3, 1.0 / sig_r**2)])
                else:
                    info = np.full(6, 1e14 if self.dtype == torch.float64 else 1e8)
                self._materialize_prior()
                for c in range(self.cfg.num_cameras):
                    i0 = self.cfg.ext_ps_offset(slot, c)
                    self.marg_H[i0: i0 + 6, i0: i0 + 6] += np.diag(info)
                self.fej_ext_t_frozen[slot] = True
                self.marg_valid = True
        else:
            # IMU link to the previous state
            last = [s for s in self.states.values() if s.id != state_id][-1]
            ts_p, gy_p, ac_p = self._pad_imu(imu_ts, imu_gyro, imu_acc, self.cfg.imu_samples)
            self.imu_links.append(ImuLinkRecord(
                id_a=last.id, id_b=state_id, ts=ts_p, gyro=gy_p, acc=ac_p,
                t0=last.timestamp, t1=float(timestamp)))
            if per_state:
                # temporal drift link (relative-pose error of variance
                # sigma_c^2 dt, Estimator.cpp:306-340)
                dt = max(float(timestamp) - last.timestamp, 1e-6)
                self.ext_links.append(dict(
                    id_a=last.id, id_b=state_id,
                    trans_var=max(self.cfg.sigma_c_relative_translation**2 * dt, 1e-16),
                    rot_var=max(self.cfg.sigma_c_relative_orientation**2 * dt, 1e-16)))
        return state_id

    # ------------------------------------------------------------------
    # deferred-propagation plumbing (add_states never waits for the card;
    # the fetch rides the association's fetch)
    # ------------------------------------------------------------------
    def _commit_prop(self, slot: int, r, q, sbv) -> None:
        self.r_WS[slot] = np.asarray(r, np.float64)
        self.q_WS[slot] = np.asarray(q, np.float64)
        self.sb[slot] = np.asarray(sbv, np.float64)

    def resolve_pending_prop(self) -> None:
        """Commit a deferred add_states propagation to the numpy tables."""
        if self._pending_prop is None:
            return
        slot, T, sb_j = self._pending_prop
        self._pending_prop = None
        with syncstats.sync("resolve_prop"):
            prop = device_get((T.r, T.q, sb_j))
        self._commit_prop(slot, *prop)

    def fetch_with_pending(self, tree):
        """device_get `tree`, committing any deferred propagation in the same
        wait for the card (one round trip instead of two)."""
        if self._pending_prop is None:
            with syncstats.sync("associate_fetch"):
                return device_get(tree)
        slot, T, sb_j = self._pending_prop
        self._pending_prop = None
        with syncstats.sync("associate_fetch"):
            res, prop = device_get((tree, (T.r, T.q, sb_j)))
        self._commit_prop(slot, *prop)
        return res

    def last_prop_device(self) -> Tuple[SE3, torch.Tensor]:
        """(T_WS, speed_and_bias) of the newest state: device values when a
        deferred propagation is pending, copies of the numpy tables
        otherwise."""
        if self._pending_prop is not None:
            _slot, T, sb_j = self._pending_prop
            return T, sb_j
        s = self._last_state()
        return SE3(r=self._t(self.r_WS[s.slot]), q=self._t(self.q_WS[s.slot])), self._t(self.sb[s.slot])

    @staticmethod
    def _pad_imu(ts, gyro, acc, P):
        ts, gyro, acc = np.asarray(ts), np.asarray(gyro), np.asarray(acc)
        n = len(ts)
        if n > P:
            # window longer than the static capacity (frame drops, resume
            # gaps): keep the endpoints and subsample uniformly; raising here
            # would turn a transient gap into a permanently growing one. Warn
            # so a too-small imu_samples capacity stays visible.
            logging.getLogger("okvis_tpu_torch").warning(
                "IMU window (%d samples) exceeds capacity %d; subsampling "
                "- preintegration loses high-frequency content. Raise "
                "imu_samples if this is not a transient gap.", n, P)
            idx = np.unique(np.round(np.linspace(0, n - 1, P)).astype(int))
            ts, gyro, acc = ts[idx], gyro[idx], acc[idx]
            n = len(ts)
        ts_p = np.full(P, ts[-1], dtype=np.float64)
        gy_p = np.tile(gyro[-1], (P, 1)).astype(np.float64)
        ac_p = np.tile(acc[-1], (P, 1)).astype(np.float64)
        ts_p[:n], gy_p[:n], ac_p[:n] = ts, gyro, acc
        return ts_p, gy_p, ac_p

    def _last_state(self) -> StateRecord:
        return next(reversed(self.states.values()))

    def _states_by_time(self) -> List[StateRecord]:
        return sorted(self.states.values(), key=lambda s: s.timestamp)

    # ------------------------------------------------------------------
    # landmarks / observations (Estimator::addLandmark / addObservation)
    # ------------------------------------------------------------------
    def add_landmark(self, lm_id: int, point_W: np.ndarray, initialized: bool = True) -> None:
        if lm_id in self.landmarks:
            raise ValueError(f"landmark {lm_id} already added")
        if not self._free_lm_slots:
            raise RuntimeError("landmark table full")
        slot = self._free_lm_slots.pop()
        self.landmarks[lm_id] = LandmarkRecord(id=lm_id, slot=slot, initialized=initialized)
        self._lm_slot_to_id[slot] = lm_id
        hp = np.asarray(point_W, dtype=np.float64)
        if hp.shape[-1] == 3:
            hp = np.concatenate([hp, [1.0]])
        self.hp_W[slot] = hp

    def is_landmark_added(self, lm_id: int) -> bool:
        return lm_id in self.landmarks

    def add_observation(self, lm_id: int, pose_id: int, cam_idx: int, keypoint: np.ndarray,
                        keypoint_idx: int = 0, size: float = 1.0) -> bool:
        """information = 64/size^2 I2 with Cauchy loss
        (implementation/Estimator.hpp:62-77).

        Returns False (input shedding) when the observation table is at
        capacity, the reference's drop-on-overload policy."""
        if len(self.observations) >= self.cfg.max_observations:
            return False
        o = Observation(lm_id=lm_id, pose_id=pose_id, cam_idx=cam_idx, keypoint_idx=keypoint_idx,
                        keypoint=np.asarray(keypoint, dtype=np.float64), size=float(size))
        if self._obs_cols.n >= self._obs_cols.cap:
            # dead rows filled the mirror: compact (re-stamps every row)
            self._obs_cols.rebuild(self.observations, self.states, self.landmarks)
        o.row = self._obs_cols.append(
            self.states[pose_id].slot, cam_idx, self.landmarks[lm_id].slot, o.keypoint, 8.0 / o.size)
        self.observations.append(o)
        self.obs_count[lm_id] = self.obs_count.get(lm_id, 0) + 1
        return True

    def remove_observation(self, lm_id: int, pose_id: int, cam_idx: int, keypoint_idx: int) -> bool:
        # reverse scan: callers (RANSAC outlier removal) target observations
        # appended this frame, which live at the tail of the list
        for i in range(len(self.observations) - 1, -1, -1):
            o = self.observations[i]
            if (o.lm_id == lm_id and o.pose_id == pose_id and o.cam_idx == cam_idx
                    and o.keypoint_idx == keypoint_idx):
                self._obs_cols.kill(o.row)
                self.observations.pop(i)
                self._dec_obs_count(lm_id)
                return True
        return False

    def _dec_obs_count(self, lm_id: int) -> None:
        n = self.obs_count.get(lm_id, 0) - 1
        if n > 0:
            self.obs_count[lm_id] = n
        else:
            self.obs_count.pop(lm_id, None)

    def _rebuild_obs_count(self) -> None:
        oc: Dict[int, int] = {}
        for o in self.observations:
            oc[o.lm_id] = oc.get(o.lm_id, 0) + 1
        self.obs_count = oc

    # ------------------------------------------------------------------
    # problem assembly (host -> device)
    # ------------------------------------------------------------------
    def _state_mask(self) -> np.ndarray:
        m = np.zeros(self.cfg.num_states, bool)
        for s in self.states.values():
            m[s.slot] = True
        return m

    def _marg_prior(self) -> MargPrior:
        return MargPrior(
            H=self._t(self.marg_H),
            b0=self._t(self.marg_b0),
            c0=self._t(self.marg_c0),
            r_WS_lin=self._t(self.fej_r_WS),
            q_WS_lin=self._t(self.fej_q_WS),
            sb_lin=self._t(self.fej_sb),
            r_SC_lin=self._t(self.fej_r_SC),
            q_SC_lin=self._t(self.fej_q_SC),
            valid=self._i(np.asarray(self.marg_valid)),
            r_SC_t_lin=self._t(self.fej_r_SC_t) if self.cfg.extrinsics_per_state else None,
            q_SC_t_lin=self._t(self.fej_q_SC_t) if self.cfg.extrinsics_per_state else None,
        )

    def _build_problem(self, pre=None, tier=None) -> BaProblem:
        """Assemble the padded device problem from host bookkeeping: every
        field is built as one host array and copied to the device once.

        With `tier` (from _select_tier), the landmark table is compacted to
        the tier's L slots and the observation table padded only to the
        tier's O; the solve is the same."""
        self.resolve_pending_prop()
        cfg = self.cfg
        S, L, O = cfg.num_states, cfg.max_landmarks, cfg.max_observations
        if tier is not None:
            L, O = tier["L"], tier["O"]
        K = cfg.max_imu_links

        state_mask = self._state_mask()
        sb_mask = np.ones(S, bool)
        for s in self.states.values():
            sb_mask[s.slot] = s.sb_active
        lm_mask = np.zeros(L, bool)
        if tier is not None:
            lm_mask[: tier["slots"].size] = True
            hp_host = np.tile([0.0, 0, 0, 1], (L, 1))
            hp_host[: tier["slots"].size] = self.hp_W[tier["slots"]]
        else:
            for lm in self.landmarks.values():
                lm_mask[lm.slot] = True
            hp_host = self.hp_W

        per_state = cfg.extrinsics_per_state
        states = WindowStates(
            r_WS=self._t(self.r_WS), q_WS=self._t(self.q_WS), speed_and_bias=self._t(self.sb),
            r_SC=self._t(self.r_SC), q_SC=self._t(self.q_SC), hp_W=self._t(hp_host),
            r_SC_t=self._t(self.r_SC_t) if per_state else None,
            q_SC_t=self._t(self.q_SC_t) if per_state else None)

        # observations: numpy gathers over the live rows of the columnar
        # mirror (the sqrt(64/size^2) weights were stamped at add time)
        t_obs0 = time.thread_time()
        cols = self._obs_cols
        rows = cols.live_rows()
        n = rows.size
        if n > O:
            raise RuntimeError(f"{n} observations exceed capacity {O}")
        o_state = np.zeros(O, np.int32)
        o_cam = np.zeros(O, np.int32)
        o_lm = np.zeros(O, np.int32)
        o_kp = np.zeros((O, 2))
        o_w = np.ones(O)
        o_mask = np.zeros(O, bool)
        if n:
            o_state[:n] = cols.state_slot[rows]
            o_cam[:n] = cols.cam[rows]
            lm_rows = cols.lm_slot[rows]
            o_lm[:n] = tier["remap"][lm_rows] if tier is not None else lm_rows
            o_kp[:n] = cols.kp[rows]
            o_w[:n] = cols.w[rows]
            o_mask[:n] = True
        Timing.add("host: obs table (np)", time.thread_time() - t_obs0)
        if _DEBUG_CHECKS:
            # the mirror is incrementally maintained derived state: verify it
            # against a fresh rebuild (OKVIS_DEBUG_CHECKS=1)
            live_obs = [o for o in self.observations if o.pose_id in self.states and o.lm_id in self.landmarks]
            assert len(live_obs) == n, (len(live_obs), n)
            for i, o in enumerate(live_obs):
                assert o_state[i] == self.states[o.pose_id].slot
                slot = self.landmarks[o.lm_id].slot
                assert o_lm[i] == (tier["remap"][slot] if tier is not None else slot)
                assert o_cam[i] == o.cam_idx
                assert np.all(o_kp[i] == o.keypoint)
        obs = Observations(
            state_idx=self._i(o_state), cam_idx=self._i(o_cam), lm_idx=self._i(o_lm),
            keypoint=self._t(o_kp), sqrt_info=self._t(o_w), mask=self._i(o_mask))

        # IMU links: re-preintegrate all at the current biases (the reference
        # re-preintegrates when |db_g| dt > 1e-4, ImuError.cpp:549-558; the
        # batched program always refreshes)
        nl = len(self.imu_links)
        if nl > K:
            raise RuntimeError("too many IMU links")
        idx_a = np.zeros(K, np.int32)
        idx_b = np.ones(K, np.int32)
        l_mask = np.zeros(K, bool)
        if nl:
            if pre is None:
                pre = self._preintegrate_links(self.imu_links, self.sb)
            for i, l in enumerate(self.imu_links):
                idx_a[i] = self.states[l.id_a].slot
                idx_b[i] = self.states[l.id_b].slot
                l_mask[i] = True
            pre_full = pre
        else:
            pre_full = self._empty_pre_template()
        links = ImuLinks(pre=pre_full, idx_a=self._i(idx_a), idx_b=self._i(idx_b), mask=self._i(l_mask))

        # priors
        Kp, Ks = cfg.max_pose_priors, cfg.max_sb_priors
        pp_idx = np.zeros(Kp, np.int32)
        pp_r = np.zeros((Kp, 3))
        pp_q = np.tile([0.0, 0, 0, 1], (Kp, 1))
        pp_W = np.zeros((Kp, 6, 6))
        pp_m = np.zeros(Kp, bool)
        for i, pr in enumerate(self.pose_priors[:Kp]):
            if pr["pose_id"] not in self.states:
                continue
            pp_idx[i] = self.states[pr["pose_id"]].slot
            pp_r[i] = pr["r"]
            pp_q[i] = pr["q"]
            pp_W[i] = pr["sqrt_info"]
            pp_m[i] = True
        pose_priors = PosePriors(state_idx=self._i(pp_idx), r_meas=self._t(pp_r), q_meas=self._t(pp_q),
                                 sqrt_info=self._t(pp_W), mask=self._i(pp_m))
        sp_idx = np.zeros(Ks, np.int32)
        sp_sb = np.zeros((Ks, 9))
        sp_W = np.zeros((Ks, 9, 9))
        sp_m = np.zeros(Ks, bool)
        for i, pr in enumerate(self.sb_priors[:Ks]):
            if pr["pose_id"] not in self.states:
                continue
            sp_idx[i] = self.states[pr["pose_id"]].slot
            sp_sb[i] = pr["sb"]
            sp_W[i] = pr["sqrt_info"]
            sp_m[i] = True
        sb_priors = SbPriors(state_idx=self._i(sp_idx), sb_meas=self._t(sp_sb), sqrt_info=self._t(sp_W),
                             mask=self._i(sp_m))

        return BaProblem(
            states=states, state_mask=self._i(state_mask), sb_mask=self._i(sb_mask),
            lm_mask=self._i(lm_mask), obs=obs, imu_links=links, pose_priors=pose_priors,
            sb_priors=sb_priors, marg=self._marg_prior(),
            ext_links=self._ext_links_table(self.ext_links) if per_state else None)

    def _ext_links_table(self, links) -> ExtLinks:
        """Padded relative-extrinsics drift factor table of `links` (per-state
        mode): one row a (link, camera); links whose states left the window
        are skipped."""
        C, Ke = self.cfg.num_cameras, self.cfg.ext_link_capacity
        el_a = np.zeros(Ke, np.int32)
        el_b = np.ones(Ke, np.int32)
        el_c = np.zeros(Ke, np.int32)
        el_W = np.zeros((Ke, 6, 6))
        el_m = np.zeros(Ke, bool)
        i = 0
        for l in links:
            if l["id_a"] not in self.states or l["id_b"] not in self.states:
                continue
            w = np.diag([1.0 / np.sqrt(l["trans_var"])] * 3 + [1.0 / np.sqrt(l["rot_var"])] * 3)
            for c in range(C):
                if i >= Ke:
                    raise RuntimeError("extrinsics link table full")
                el_a[i], el_b[i] = self.states[l["id_a"]].slot, self.states[l["id_b"]].slot
                el_c[i], el_W[i], el_m[i] = c, w, True
                i += 1
        return ExtLinks(idx_a=self._i(el_a), idx_b=self._i(el_b), cam=self._i(el_c), sqrt_info=self._t(el_W),
                        mask=self._i(el_m))

    def _preintegrate_links(self, links, sb_source: np.ndarray):
        """Batched preintegration of a list of links, padded to the static
        capacity max_imu_links (padding rows have t1 == t0: identity
        increments, ignored by the masks). Each link's timestamps are
        rebased to its start time. sb_source is the (S, 9) table the
        linearization biases come from (current estimates for optimize, FEJ
        for marginalization)."""
        with Timer("preintegrate"):
            return self._preintegrate_fn(*(self._t(x) for x in self._link_tables(links, sb_source)))

    def _link_tables(self, links, sb_source: np.ndarray) -> tuple:
        """preintegrate's padded host arguments for `links` (timestamps,
        gyro, acc, t0, t1, sb_ref), each link rebased to its start time."""
        K, P = self.cfg.max_imu_links, self.cfg.imu_samples
        ts = np.zeros((K, P))
        gy = np.zeros((K, P, 3))
        ac = np.zeros((K, P, 3))
        t1 = np.zeros(K)
        sbr = np.zeros((K, 9))
        for i, l in enumerate(links):
            ts[i], gy[i], ac[i] = l.ts - l.t0, l.gyro, l.acc
            t1[i] = l.t1 - l.t0
            sbr[i] = sb_source[self.states[l.id_a].slot]
        return ts, gy, ac, np.zeros(K), t1, sbr

    def _empty_pre_template(self):
        if "pre_tmpl" not in self._jit_cache:
            self._jit_cache["pre_tmpl"] = empty_problem(self.cfg, dtype=self.dtype, device=self.device).imu_links.pre
        return self._jit_cache["pre_tmpl"]

    # ------------------------------------------------------------------
    # optimize (Estimator::optimize, Estimator.cpp:842-906)
    # ------------------------------------------------------------------
    def optimize(self, max_iterations: Optional[int] = None, verbose: bool = False,
                 time_limit: Optional[float] = None, min_iterations: Optional[int] = None):
        """One full window solve. With `time_limit` set (and a single-device
        solve), runs the chunked wall-clock budget contract (the reference's
        CeresIterationCallback semantics): >= min_iterations always, up to
        max_iterations while under budget."""
        with Timer("host: build problem"):
            tier = self._select_tier()
            LO = None if tier is None else (tier["L"], tier["O"])
            problem = self._build_problem(tier=tier)
        with timing.span("optimize.enqueue"):
            if time_limit is not None and self._mesh is None:
                states, diag = self._optimize_deadline(
                    problem, time_limit, min_iterations if min_iterations is not None else 1,
                    max_iterations if max_iterations is not None else self.cfg.max_iterations, LO=LO)
            else:
                fn = self._optimize_fn(max_iterations, LO=LO)
                states, diag = fn(problem)
                if capture.enabled:
                    capture.record("optimize", fn, problem)
                    capture.record_output("optimize", (states, diag))
        if tier is not None and os.environ.get("OKVIS_TIER_CROSSCHECK"):
            p_full = self._build_problem()
            s2, d2 = self._optimize_fn(max_iterations)(p_full)
            slots = torch.from_numpy(tier["slots"]).to(self.device)
            dr = float((states.r_WS - s2.r_WS).abs().max())
            dhp = float((states.hp_W[: slots.numel()] - s2.hp_W[slots]).abs().max())
            dc = float((diag.final_cost - d2.final_cost).abs())
            tcfg = self._tier_cfg(self.cfg, LO)
            c0_t = float(evaluate(tcfg, self.imu_params, self.intrinsics, problem, problem.states).cost)
            c0_f = float(evaluate(self.cfg, self.imu_params, self.intrinsics, p_full, p_full.states).cost)
            print(f"[tier-crosscheck] L={tier['L']} O={tier['O']} dr={dr:.3e} dhp={dhp:.3e} "
                  f"dcost={dc:.3e} c0_tier={c0_t:.6f} c0_full={c0_f:.6f}", flush=True)
        # pull back the results in one device-to-host copy
        pulls = [states.r_WS, states.q_WS, states.speed_and_bias, states.hp_W]
        if self.cfg.extrinsics_per_state:
            pulls += [states.r_SC_t, states.q_SC_t]
        elif self.cfg.estimate_extrinsics:
            pulls += [states.r_SC, states.q_SC]
        # landmark quality (Estimator.cpp:880-900), carried out of the final
        # normal equations by the solve
        extra_quality = diag.landmark_quality is None
        if not extra_quality:
            pulls.append(diag.landmark_quality)
        # in a traced frame the iteration counts ride the same copy
        solver_pulls = ([diag.cost_history, diag.accepted] + ([] if diag.initial_cost is None else [diag.initial_cost])
                        if timing.tracing() else [])
        pulls += solver_pulls
        with syncstats.sync("optimize_fetch"):
            flat = torch.cat([p.reshape(-1).to(self.dtype) for p in pulls]).cpu().to(torch.float64).numpy()
        fetched, off = [], 0
        for p in pulls:
            fetched.append(flat[off: off + p.numel()].reshape(p.shape))
            off += p.numel()
        if solver_pulls:
            k = len(pulls) - len(solver_pulls)
            hist, acc = fetched[k], fetched[k + 1]
            cost0 = float(fetched[k + 2]) if diag.initial_cost is not None else None
            timing.annotate("3.1 optimization", iterations=int(hist.size), accepted=int(acc.sum()),
                            useful=useful_iterations(hist, acc.astype(bool), cost0))
        with Timer("host: optimize update"):
            self._update_from_fetch(fetched, tier, problem, states, extra_quality)
        if verbose:
            print(f"optimize: cost {float(diag.final_cost):.3f} "
                  f"accepted {int(diag.accepted.sum())}/{self.cfg.max_iterations}")
        return diag

    def _update_from_fetch(self, fetched, tier, problem, states, extra_quality) -> None:
        """optimize's host update from its one fetch: the window's tables,
        the calibration and the landmark qualities."""
        if tier is not None:
            # scatter the compact landmark table back to the stable slots
            self.r_WS, self.q_WS, self.sb = (f.copy() for f in fetched[:3])
            self.hp_W[tier["slots"]] = fetched[3][: tier["slots"].size]
        else:
            self.r_WS, self.q_WS, self.sb, self.hp_W = (f.copy() for f in fetched[:4])
        i = 4
        if self.cfg.extrinsics_per_state:
            self.r_SC_t, self.q_SC_t = fetched[i].copy(), fetched[i + 1].copy()
            i += 2
            # the newest state's calibration mirrors into the shared tables
            # the frontend reads
            newest = self._last_state()
            self.r_SC = self.r_SC_t[newest.slot].copy()
            self.q_SC = self.q_SC_t[newest.slot].copy()
        elif self.cfg.estimate_extrinsics:
            self.r_SC, self.q_SC = fetched[i].copy(), fetched[i + 1].copy()
            i += 2
        if not extra_quality:
            quality = fetched[i]
        else:
            quality = self._landmark_quality_fn(problem._replace(states=states))
            with syncstats.sync("lmq_fetch"):
                quality = _host(quality)
        for lm in self.landmarks.values():
            lm.quality = float(quality[tier["remap"][lm.slot] if tier is not None else lm.slot])
            # a landmark becomes initialized once its 3x3 Hessian is
            # well-conditioned (depth observable), Estimator.cpp:880-900
            if not lm.initialized and lm.quality > 1e-3:
                lm.initialized = True

    # ------------------------------------------------------------------
    # marginalization (Estimator::applyMarginalizationStrategy)
    # ------------------------------------------------------------------
    def apply_marginalization_strategy(self) -> List[int]:
        """Returns ids of removed landmarks."""
        self.resolve_pending_prop()
        by_time = self._states_by_time()
        if len(by_time) <= self.num_imu_frames:
            return []
        old_frames = by_time[: -self.num_imu_frames]  # beyond the IMU horizon
        # newest-first like the reference's reverse iteration
        old_newest_first = old_frames[::-1]
        remove_frames: List[StateRecord] = []
        counted_kf = 0
        for s in old_newest_first:
            if (not s.is_keyframe) or counted_kf >= self.num_keyframes:
                remove_frames.append(s)
            else:
                counted_kf += 1
        all_linearized = [s.id for s in old_newest_first]
        if not all_linearized:
            return []
        current_kf_id = all_linearized[0]
        remove_ids = {s.id for s in remove_frames}

        # --- collect what to absorb ---
        absorb_links: List[ImuLinkRecord] = []
        absorb_sb_priors: List[dict] = []
        marg_sb_states: List[StateRecord] = []
        for s in old_frames:
            if not s.sb_active:
                continue
            marg_sb_states.append(s)
            s.sb_active = False
            for l in list(self.imu_links):
                if l.id_a == s.id or l.id_b == s.id:
                    absorb_links.append(l)
                    self.imu_links.remove(l)
            for pr in list(self.sb_priors):
                if pr["pose_id"] == s.id:
                    absorb_sb_priors.append(pr)
                    self.sb_priors.remove(pr)

        # pose priors on removed frames: drop + re-fixation (Estimator.cpp:571-577, 760-772)
        redo_fixation = False
        for s in remove_frames:
            for pr in list(self.pose_priors):
                if pr["pose_id"] == s.id:
                    self.pose_priors.remove(pr)
                    redo_fixation = True

        # per-state extrinsics blocks of removed frames are marginalized with
        # the pose, their drift links absorbed into the prior
        # (Estimator.cpp:587-619)
        absorb_ext_links: List[dict] = []
        if self.cfg.extrinsics_per_state:
            for s in remove_frames:
                for l in list(self.ext_links):
                    if l["id_a"] == s.id or l["id_b"] == s.id:
                        absorb_ext_links.append(l)
                        self.ext_links.remove(l)

        # --- landmark triage (Estimator.cpp:624-725) ---
        # absorbed observations carry their landmark slot (the landmark record
        # is removed only after the marginalization step consumed the slot)
        absorb_obs: List[Tuple[Observation, int]] = []
        removed_landmark_ids: List[int] = []
        pending_lm_removal: List[int] = []
        marg_lm_slots: List[int] = []
        if remove_frames:
            lin_set = set(all_linearized)
            # group observations by landmark once; collect removals by
            # identity for a single filter pass at the end
            by_lm: Dict[int, List[Observation]] = {}
            for o in self.observations:
                by_lm.setdefault(o.lm_id, []).append(o)
            dropped_ids: set = set()

            def _drop(o: Observation) -> None:
                dropped_ids.add(id(o))
                self._obs_cols.kill(o.row)
                self._dec_obs_count(o.lm_id)

            for lm_id in list(self.landmarks.keys()):
                lm_slot = self.landmarks[lm_id].slot
                lm_obs = by_lm.get(lm_id, [])
                if not lm_obs:
                    pending_lm_removal.append(lm_id)
                    removed_landmark_ids.append(lm_id)
                    continue
                if not any(o.pose_id in remove_ids for o in lm_obs):
                    continue  # skipLandmark
                has_new = any(o.pose_id >= current_kf_id for o in lm_obs)
                marginalize = not has_new
                obs_count = sum(1 for o in lm_obs if o.pose_id in lin_set)
                error_term_added = False
                kept: List[Observation] = []
                for o in lm_obs:
                    if (o.pose_id in remove_ids and has_new) or (o.pose_id not in lin_set and marginalize):
                        _drop(o)
                    elif marginalize and o.pose_id in lin_set:
                        if obs_count < 2:
                            _drop(o)
                        else:
                            absorb_obs.append((o, lm_slot))
                            _drop(o)
                            error_term_added = True
                    else:
                        kept.append(o)
                if not kept:
                    if error_term_added:
                        marg_lm_slots.append(lm_slot)
                    pending_lm_removal.append(lm_id)
                    removed_landmark_ids.append(lm_id)
                elif marginalize and error_term_added:
                    # should not happen: marginalize implies all obs absorbed/removed
                    marg_lm_slots.append(lm_slot)
                    pending_lm_removal.append(lm_id)
                    removed_landmark_ids.append(lm_id)
            if dropped_ids:
                self.observations = [o for o in self.observations if id(o) not in dropped_ids]

        # --- freeze FEJ points of involved kept blocks ---
        involved_ids = set()
        for l in absorb_links:
            involved_ids.update((l.id_a, l.id_b))
        for o, _slot in absorb_obs:
            involved_ids.add(o.pose_id)
        for s in marg_sb_states + remove_frames:
            involved_ids.add(s.id)
        for l in absorb_ext_links:
            involved_ids.update((l["id_a"], l["id_b"]))
        for sid in involved_ids:
            if sid in self.states:
                s = self.states[sid]
                if not s.fej_frozen:
                    self.fej_r_WS[s.slot] = self.r_WS[s.slot]
                    self.fej_q_WS[s.slot] = self.q_WS[s.slot]
                    self.fej_sb[s.slot] = self.sb[s.slot]
                    s.fej_frozen = True
                if self.cfg.extrinsics_per_state and not self.fej_ext_t_frozen[s.slot]:
                    self.fej_r_SC_t[s.slot] = self.r_SC_t[s.slot]
                    self.fej_q_SC_t[s.slot] = self.q_SC_t[s.slot]
                    self.fej_ext_t_frozen[s.slot] = True

        # --- build masks ---
        D = self.cfg.dense_dim
        marg_dense = np.zeros(D, bool)
        for s in marg_sb_states:
            marg_dense[s.slot * 15 + 6: s.slot * 15 + 15] = True
        for s in remove_frames:
            marg_dense[s.slot * 15: s.slot * 15 + 6] = True
            if self.cfg.extrinsics_per_state:
                i0 = self.cfg.ext_ps_offset(s.slot, 0)
                marg_dense[i0: i0 + 6 * self.cfg.num_cameras] = True
        marg_lm_mask = np.zeros(self.cfg.max_landmarks, bool)
        for slot in marg_lm_slots:
            marg_lm_mask[slot] = True

        if self.cfg.estimate_extrinsics and not self.fej_ext_frozen:
            self.fej_r_SC = self.r_SC.copy()
            self.fej_q_SC = self.q_SC.copy()
            self.fej_ext_frozen = True

        any_marg = marg_dense.any() or marg_lm_mask.any()
        if any_marg and (absorb_links or absorb_obs or absorb_sb_priors or absorb_ext_links or self.marg_valid):
            m_tier = self._select_marg_tier(absorb_obs, marg_lm_slots)
            m_LO = None if m_tier is None else (m_tier["L"], m_tier["O"])
            problem = self._build_marg_problem(
                absorb_links, absorb_obs, absorb_sb_priors, marg_lm_slots, marg_lm_mask, absorb_ext_links,
                tier=m_tier)
            # the host's state mask, never read back from the device
            keep_dense = dense_dim_mask(
                self.cfg, torch.from_numpy(self._state_mask() | self._prior_covered_state_mask()),
                None).numpy() & ~marg_dense
            # the problem's lm_mask is the marginalized-landmark selector
            # (identical in full mode; remapped in a tier)
            marg_fn = self._marginalize_fn_LO(m_LO)
            marg_args = (problem, self._i(marg_dense), self._i(keep_dense), problem.lm_mask)
            with timing.span("marginalize"):
                out = marg_fn(*marg_args)
            if capture.enabled:
                capture.record("marginalize", marg_fn, *marg_args)
                capture.record_output("marginalize", out)
            # keep the prior device-resident: no download here and no
            # re-upload in the next _build_problem
            self.marg_H = out.H
            self.marg_b0 = out.b0
            self.marg_c0 = out.c0
            self.marg_valid = True

        # --- now free the marginalized/deleted landmarks (one pass) ---
        if pending_lm_removal:
            self._remove_landmarks(pending_lm_removal)

        # --- drop removed frames ---
        for s in remove_frames:
            del self.states[s.id]
            self.multiframes.pop(s.id, None)
            self._free_state_slots.append(s.slot)
            # slot is clean in the prior (its dims were just eliminated)
            self.states_slot_reset(s.slot)
        # drop dangling observations of removed frames (already handled by
        # triage, but catch strays)
        n_before = len(self.observations)
        kept_obs = []
        for o in self.observations:
            if o.pose_id in self.states:
                kept_obs.append(o)
            else:
                self._obs_cols.kill(o.row)
        self.observations = kept_obs
        if len(self.observations) != n_before:
            self._rebuild_obs_count()
        if _DEBUG_CHECKS:
            oc: Dict[int, int] = {}
            for o in self.observations:
                oc[o.lm_id] = oc.get(o.lm_id, 0) + 1
            assert oc == self.obs_count, "obs_count desynced from observations after marginalization"

        if redo_fixation and self.states:
            oldest = self._states_by_time()[0]
            # the reference uses information 1e14 (Estimator.cpp:765-770); in
            # float32 that destroys the solve's conditioning, so 1e8 there
            # (still far above any data term; pure gauge fixing)
            w = 1e7 if self.dtype == torch.float64 else 1e4
            self.pose_priors.append(dict(
                pose_id=oldest.id, r=self.r_WS[oldest.slot].copy(), q=self.q_WS[oldest.slot].copy(),
                sqrt_info=np.diag([w, w, w, 0.0, 0.0, w])))
        return removed_landmark_ids

    def _prior_covered_state_mask(self) -> np.ndarray:
        m = np.zeros(self.cfg.num_states, bool)
        for s in self.states.values():
            if s.fej_frozen:
                m[s.slot] = True
        return m

    def states_slot_reset(self, slot: int) -> None:
        spans = [(slot * 15, slot * 15 + 15)]
        if self.cfg.extrinsics_per_state:
            e0 = self.cfg.ext_ps_offset(slot, 0)
            spans.append((e0, e0 + 6 * self.cfg.num_cameras))
            self.fej_ext_t_frozen[slot] = False
        for a, b in spans:
            if isinstance(self.marg_H, torch.Tensor):
                # device-resident prior: in-place zeroing of views, no host copy
                self.marg_H[a:b, :].zero_()
                self.marg_H[:, a:b].zero_()
                self.marg_b0[a:b].zero_()
            else:
                self.marg_H[a:b, :] = 0.0
                self.marg_H[:, a:b] = 0.0
                self.marg_b0[a:b] = 0.0

    def _remove_landmark(self, lm_id: int) -> None:
        self._remove_landmarks((lm_id,))

    def _remove_landmarks(self, lm_ids) -> None:
        """Batch landmark removal: one pass over the observation list for any
        number of landmarks."""
        ids = set(lm_ids)
        for lm_id in ids:
            lm = self.landmarks.pop(lm_id)
            self._free_lm_slots.append(lm.slot)
            self._lm_slot_to_id.pop(lm.slot, None)
            self.obs_count.pop(lm_id, None)
        if self._mesh is not None:
            # keep the slot hand-out round-robin over the shard blocks as
            # slots churn (shard_problem sheds a shard's overflow; balance
            # avoids it)
            self._rebalance_free_lm_slots()
        kept_obs = []
        for o in self.observations:
            if o.lm_id in ids:
                self._obs_cols.kill(o.row)
            else:
                kept_obs.append(o)
        self.observations = kept_obs

    def _build_marg_problem(self, absorb_links, absorb_obs, absorb_sb_priors, marg_lm_slots, marg_lm_mask,
                            absorb_ext_links=(), tier=None) -> BaProblem:
        """Problem holding exactly the factors to absorb, with the states at
        their FEJ linearization points (frozen for prior-covered states,
        current for the landmarks being eliminated). With `tier` (from
        _select_marg_tier) the landmark table is compacted to the referenced
        slots and the padding reduced: the same math, a smaller program."""
        cfg = self.cfg if tier is None else self._tier_cfg(self.cfg, (tier["L"], tier["O"]))
        p = empty_problem(cfg, dtype=self.dtype, device=self.device)

        if tier is not None:
            hp_host = np.tile([0.0, 0, 0, 1], (tier["L"], 1))
            hp_host[: tier["slots"].size] = self.hp_W[tier["slots"]]
        else:
            hp_host = self.hp_W
        per_state = cfg.extrinsics_per_state
        states = p.states._replace(
            r_WS=self._t(self.fej_r_WS), q_WS=self._t(self.fej_q_WS), speed_and_bias=self._t(self.fej_sb),
            r_SC=self._t(self.fej_r_SC), q_SC=self._t(self.fej_q_SC), hp_W=self._t(hp_host),
            r_SC_t=self._t(self.fej_r_SC_t) if per_state else None,
            q_SC_t=self._t(self.fej_q_SC_t) if per_state else None)

        obs = p.obs
        if absorb_obs:
            O = cfg.max_observations
            o_state = np.zeros(O, np.int32)
            o_cam = np.zeros(O, np.int32)
            o_lm = np.zeros(O, np.int32)
            o_kp = np.zeros((O, 2))
            o_w = np.ones(O)
            o_mask = np.zeros(O, bool)
            for i, (o, slot) in enumerate(absorb_obs):
                o_state[i] = self.states[o.pose_id].slot
                o_cam[i] = o.cam_idx
                o_lm[i] = tier["remap"][slot] if tier is not None else slot
                o_kp[i] = o.keypoint
                o_w[i] = 8.0 / o.size
                o_mask[i] = True
            obs = Observations(state_idx=self._i(o_state), cam_idx=self._i(o_cam), lm_idx=self._i(o_lm),
                               keypoint=self._t(o_kp), sqrt_info=self._t(o_w), mask=self._i(o_mask))

        links = p.imu_links
        if absorb_links:
            K = self.cfg.max_imu_links
            pre = self._preintegrate_links(absorb_links, self.fej_sb)
            idx_a = np.zeros(K, np.int32)
            idx_b = np.ones(K, np.int32)
            l_mask = np.zeros(K, bool)
            for i, l in enumerate(absorb_links):
                idx_a[i] = self.states[l.id_a].slot
                idx_b[i] = self.states[l.id_b].slot
                l_mask[i] = True
            links = ImuLinks(pre=pre, idx_a=self._i(idx_a), idx_b=self._i(idx_b), mask=self._i(l_mask))

        Ks = cfg.max_sb_priors
        sp_idx = np.zeros(Ks, np.int32)
        sp_sb = np.zeros((Ks, 9))
        sp_W = np.zeros((Ks, 9, 9))
        sp_m = np.zeros(Ks, bool)
        for i, pr in enumerate(absorb_sb_priors[:Ks]):
            sp_idx[i] = self.states[pr["pose_id"]].slot
            sp_sb[i] = pr["sb"]
            sp_W[i] = pr["sqrt_info"]
            sp_m[i] = True
        sp = SbPriors(state_idx=self._i(sp_idx), sb_meas=self._t(sp_sb), sqrt_info=self._t(sp_W),
                      mask=self._i(sp_m))

        if tier is not None:
            lm_mask = np.zeros(cfg.max_landmarks, bool)
            if len(marg_lm_slots):
                lm_mask[tier["remap"][np.asarray(marg_lm_slots, int)]] = True
        else:
            lm_mask = marg_lm_mask
        ext_links = p.ext_links
        if per_state and absorb_ext_links:
            ext_links = self._ext_links_table(absorb_ext_links)
        return p._replace(states=states, state_mask=self._i(self._state_mask()), lm_mask=self._i(lm_mask),
                          obs=obs, imu_links=links, sb_priors=sp, marg=self._marg_prior(), ext_links=ext_links)

    # ------------------------------------------------------------------
    # checkpoint / resume (the JAX package's estimator.py:1863-1948)
    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Write the estimator's state for a resume: the host state of
        convert.estimator_to_numpy (window, landmarks, factor tables, FEJ
        points, marginal prior) and the window's multiframe keypoint tables
        (uv, score, mask, descriptors, landmark ids, sizes; no images), as
        plain values and numpy arrays in a pickle. The file is the port's
        own: it does not read the JAX package's checkpoint, whose pickle
        holds JAX arrays, nor does the JAX package read this one."""
        from .. import convert  # convert imports this module

        blob = dict(format=CHECKPOINT_FORMAT, estimator=convert.estimator_to_numpy(self),
                    prior_on_device=isinstance(self.marg_H, torch.Tensor),
                    multiframes=[convert.multiframe_to_numpy(mf) for mf in self.multiframes.values()])
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    def load_checkpoint(self, path: str) -> None:
        """Restore a file of save_checkpoint into an estimator built with
        the same rig and window. A marginal prior that was on the device
        goes back to the estimator's device (a host prior, as before the
        first marginalization, stays float64 on the host), multiframes go
        to the rig's device, and IdProvider moves past every restored id.
        Unpickles the file: load only files this program wrote."""
        from .. import convert  # convert imports this module

        with open(path, "rb") as f:
            blob = pickle.load(f)
        if not isinstance(blob, dict) or blob.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(f"{path}: not a checkpoint of okvis_tpu_torch's Estimator")
        convert.load_estimator_state(self, blob["estimator"])
        if blob["prior_on_device"]:
            self.marg_H, self.marg_b0, self.marg_c0 = (self._t(x) for x in (self.marg_H, self.marg_b0, self.marg_c0))
        self.multiframes = {}
        for m in blob["multiframes"]:
            dtype = torch.from_numpy(m["frames"][0]["uv"]).dtype
            self.multiframes[m["id"]] = convert.multiframe_from_numpy(m, device=self.rig.device, dtype=dtype)
        # fresh ids must never collide with restored ones, including stale
        # ids of removed landmarks that frame tables still hold
        max_seen = max([0, *self.states, *self.landmarks,
                        *(int(fd.landmark_ids.max()) for mf in self.multiframes.values() for fd in mf.frames
                          if fd.landmark_ids.size)])
        IdProvider.advance_past(max_seen)

    # ------------------------------------------------------------------
    # getters/setters (Estimator.hpp:424-556); poses come back as float64
    # CPU tensors of the host tables
    # ------------------------------------------------------------------
    def get_T_WS(self, state_id: int) -> kin.SE3:
        self.resolve_pending_prop()
        s = self.states[state_id]
        return kin.SE3(r=torch.from_numpy(self.r_WS[s.slot].copy()), q=torch.from_numpy(self.q_WS[s.slot].copy()))

    def set_T_WS(self, state_id: int, T: kin.SE3) -> None:
        self.resolve_pending_prop()
        s = self.states[state_id]
        self.r_WS[s.slot] = _host(T.r)
        self.q_WS[s.slot] = _host(T.q)

    def get_speed_and_bias(self, state_id: int) -> np.ndarray:
        self.resolve_pending_prop()
        return self.sb[self.states[state_id].slot].copy()

    def set_speed_and_bias(self, state_id: int, sb: np.ndarray) -> None:
        self.resolve_pending_prop()
        self.sb[self.states[state_id].slot] = _host(sb)

    def get_landmark(self, lm_id: int) -> np.ndarray:
        return self.hp_W[self.landmarks[lm_id].slot].copy()

    def set_landmark(self, lm_id: int, hp: np.ndarray) -> None:
        hp = np.asarray(hp, dtype=np.float64)
        if hp.shape[-1] == 3:
            hp = np.concatenate([hp, [1.0]])
        self.hp_W[self.landmarks[lm_id].slot] = hp

    def set_keyframe(self, state_id: int, is_keyframe: bool) -> None:
        self.states[state_id].is_keyframe = is_keyframe

    def is_keyframe(self, state_id: int) -> bool:
        return self.states[state_id].is_keyframe

    def num_frames(self) -> int:
        return len(self.states)

    def num_landmarks(self) -> int:
        return len(self.landmarks)

    def current_frame_id(self) -> int:
        return self._last_state().id

    def get_extrinsics(self, cam_idx: int, state_id: Optional[int] = None) -> kin.SE3:
        """Camera extrinsics T_SC. In per-state mode, `state_id` selects a
        state's block (default: the shared mirror, which optimize keeps at
        the newest state's estimate)."""
        if self.cfg.extrinsics_per_state and state_id is not None:
            slot = self.states[state_id].slot
            return kin.SE3(r=torch.from_numpy(self.r_SC_t[slot, cam_idx].copy()),
                           q=torch.from_numpy(self.q_SC_t[slot, cam_idx].copy()))
        return kin.SE3(r=torch.from_numpy(self.r_SC[cam_idx].copy()),
                       q=torch.from_numpy(self.q_SC[cam_idx].copy()))

    def landmark_observation_count(self, lm_id: int) -> int:
        return self.obs_count.get(lm_id, 0)
