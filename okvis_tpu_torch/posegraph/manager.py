"""Pose-graph manager: odometry edges, loop detection, correction, culling
(port of okvis_tpu.posegraph.manager).

Flow per keyframe:

1. add a node at the drift-corrected VIO pose and an odometry edge carrying
   the VIO relative transform (locally drift-free),
2. retrieve a loop candidate (place_recognition.py: one Hamming launch),
3. verify it geometrically (loop_closure.py: matching + 3D-2D RANSAC),
4. on a confirmed loop: add the loop edge, run the pose-graph solver
   (optimize.py), and update the world correction
   ``T_corr = T_opt_latest * T_vio_latest^-1`` that maps live VIO output
   into the loop-consistent frame,
5. optional redundant-keyframe culling keeps the graph bounded (edge
   composition through removed nodes, graph.py).

The device work (retrieval, verification, the solve) runs in float64 on the
manager's device whatever the estimator's float type: the graph container
asks for float64 and verification casts the landmarks to it. The RANSAC
uniforms come from one `_draw`, a torch.Generator seeded `cfg.seed` (the
JAX package splits one key a verification), so tests can replay the JAX
package's draws. The manager reads the device at three points, as the JAX
package does: the query's best slot and scores, the verification's inlier
count and flag, and the solved poses (syncstats `posegraph_*`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kinematics import np_se3
from ..utils import syncstats
from . import loop_closure as lc
from .graph import PoseGraph
from .place_recognition import KeyframeDatabase, as_words

Pose = Tuple[np.ndarray, np.ndarray]


@dataclass
class PoseGraphConfig:
    # retrieval
    score_threshold: float = 0.22
    vote_threshold: int = 60
    min_gap: int = 10  # exclude this many most-recent keyframes
    # verification
    match_threshold: int = 60
    min_inliers: int = 20
    focal: float = 460.0
    # odometry edge noise (per meter-ish step; VIO relative poses are stiff)
    odom_sigma_t: float = 0.01
    odom_sigma_r: float = 0.003
    # solver
    max_iterations: int = 10
    # pcg_iters applies only when the resolved solver is "pcg": with
    # solver="auto" and node_capacity <= 341 the dense path ignores it
    pcg_iters: int = 60
    solver: str = "auto"  # "dense" | "pcg" | "auto" (dense when 6N <= 2048)
    # culling
    cull_min_translation: float = 0.05
    cull_min_rotation: float = 0.05
    # capacities
    node_capacity: int = 256
    edge_capacity: int = 512
    db_kp_capacity: int = 512
    desc_words: int = 64  # descriptor packing (16 x uint32 in the pipeline)
    desc_dtype: type = None  # defaults to uint8; the pipeline passes uint32
    seed: int = 7


@dataclass
class LoopEvent:
    query_id: int
    candidate_id: int
    score: float
    num_inliers: int
    accepted: bool


class PoseGraphManager:
    """`device` is where retrieval, verification and the solve run: the
    CUDA card unless the caller passes device="cpu"."""

    def __init__(self, config: Optional[PoseGraphConfig] = None, T_SC: Optional[Pose] = None, device=None):
        self.cfg = config or PoseGraphConfig()
        self.device = resolve_device(device)
        self.graph = PoseGraph(self.cfg.node_capacity, self.cfg.edge_capacity, device=self.device)
        self.db = KeyframeDatabase(self.cfg.node_capacity, self.cfg.db_kp_capacity, desc_words=self.cfg.desc_words,
                                   desc_dtype=self.cfg.desc_dtype or np.uint8, device=self.device)
        self.T_SC: Pose = T_SC if T_SC is not None else (np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
        self.prev_kf_id: Optional[int] = None
        self.prev_vio_pose: Optional[Pose] = None
        self.vio_pose_of: Dict[int, Pose] = {}
        self.timestamps: Dict[int, int] = {}
        self.insert_order: List[int] = []
        # accumulated world correction T_Wcorr <- T_Wvio
        self.corr_r = np.zeros(3)
        self.corr_q = np.array([0.0, 0.0, 0.0, 1.0])
        self.loop_events: List[LoopEvent] = []
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.cfg.seed)

    def _draw(self, shape) -> torch.Tensor:
        """The next verification's RANSAC uniforms, [0, 1) float64 on the
        manager's device."""
        return torch.rand(shape, generator=self._gen, dtype=torch.float64, device=self.device)

    # ------------------------------------------------------------------ api
    def correction(self) -> Pose:
        """Current T_corr: corrected = T_corr * vio."""
        return self.corr_r.copy(), self.corr_q.copy()

    def apply_correction(self, r_vio: np.ndarray, q_vio: np.ndarray) -> Pose:
        return np_se3.compose(self.corr_r, self.corr_q, r_vio, q_vio)

    def add_keyframe(
        self,
        kf_id: int,
        timestamp_ns: int,
        r_WS_vio: np.ndarray,
        q_WS_vio: np.ndarray,
        descriptors: np.ndarray,  # (K, 64) uint8 or (K, 16) uint32
        desc_mask: np.ndarray,  # (K,) bool
        bearings_C: np.ndarray,  # (K, 3) unit bearings, camera frame
        landmarks_W: np.ndarray,  # (K, 3) landmark positions (VIO world)
        lm_valid: np.ndarray,  # (K,) bool
    ) -> Optional[LoopEvent]:
        """Insert a keyframe; returns a LoopEvent when a candidate was
        verified (accepted or not)."""
        cfg = self.cfg
        r_vio = np.asarray(r_WS_vio, np.float64)
        q_vio = np.asarray(q_WS_vio, np.float64)
        self.vio_pose_of[kf_id] = (r_vio.copy(), q_vio.copy())
        self.timestamps[kf_id] = timestamp_ns

        # node at the corrected pose; the first node fixed (gauge)
        r0, q0 = self.apply_correction(r_vio, q_vio)
        self.graph.add_node(kf_id, r0, q0, fixed=self.graph.n_nodes == 0)

        # odometry edge from the VIO relative pose
        if self.prev_kf_id is not None:
            t_ij, q_ij = np_se3.relative(*self.prev_vio_pose, r_vio, q_vio)
            w = np.concatenate([np.full(3, 1.0 / cfg.odom_sigma_t), np.full(3, 1.0 / cfg.odom_sigma_r)])
            self.graph.add_edge(self.prev_kf_id, kf_id, t_ij, q_ij, np.diag(w), kind=0)

        event = self._detect_and_close_loop(kf_id, descriptors, desc_mask, bearings_C)

        # the retrieval database keeps geometry in the VIO world, so RANSAC
        # stays consistent with the stored landmark coordinates
        self.db.insert(kf_id, descriptors, desc_mask, bearings_C, landmarks_W, lm_valid)
        self.insert_order.append(kf_id)
        self.prev_kf_id = kf_id
        self.prev_vio_pose = (r_vio.copy(), q_vio.copy())
        return event

    # ------------------------------------------------------- loop pipeline
    def _detect_and_close_loop(self, kf_id: int, desc: np.ndarray, mask: np.ndarray,
                               bearings_C: np.ndarray) -> Optional[LoopEvent]:
        cfg = self.cfg
        exclude = set(self.insert_order[-cfg.min_gap:])
        cand_id, score, _ = self.db.query(desc, mask, exclude, vote_threshold=cfg.vote_threshold)
        if cand_id is None or score < cfg.score_threshold:
            return None

        desc_c, _, _, lms_W, lm_valid = self.db.geometry_of(cand_id)
        # the query side padded to the database's keypoint capacity
        kp_cap = self.db.kp_cap
        kq = min(len(desc), bearings_C.shape[0], kp_cap)
        dq = np.zeros((kp_cap, desc.shape[1]), desc.dtype)
        mq = np.zeros(kp_cap, bool)
        bq = np.zeros((kp_cap, 3), np.float64)
        dq[:kq] = desc[:kq]
        mq[:kq] = mask[:kq]
        bq[:kq] = bearings_C[:kq]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        ver = lc.verify_loop_candidate(
            self._draw((lc.N_HYP, 3)), t(as_words(desc_c)), t(lm_valid), t(np.asarray(lms_W, np.float64)),
            t(as_words(dq)), t(mq), t(bq), focal=cfg.focal, match_threshold=cfg.match_threshold,
            min_inliers=cfg.min_inliers)
        syncstats.bump("posegraph_verify")
        num_inliers, accepted = (int(x) for x in torch.stack([ver.num_inliers, ver.success.to(torch.int64)]).cpu())
        event = LoopEvent(query_id=kf_id, candidate_id=cand_id, score=score, num_inliers=num_inliers,
                          accepted=bool(accepted))
        self.loop_events.append(event)
        if not event.accepted:
            return event

        rel = lc.relative_pose_from_verification(ver, self.vio_pose_of[cand_id], self.T_SC)
        self.graph.add_edge(cand_id, kf_id, rel[0], rel[1], lc.loop_edge_sqrt_info(event.num_inliers), kind=1)
        self._optimize_and_update_correction(kf_id)
        return event

    def _optimize_and_update_correction(self, latest_id: int) -> None:
        syncstats.bump("posegraph_solve")
        self.graph.optimize(max_iterations=self.cfg.max_iterations, pcg_iters=self.cfg.pcg_iters,
                            solver=self.cfg.solver)
        r_opt, q_opt = self.graph.get_pose(latest_id)
        r_inv, q_inv = np_se3.inverse(*self.vio_pose_of[latest_id])
        self.corr_r, self.corr_q = np_se3.compose(r_opt, q_opt, r_inv, q_inv)

    # ------------------------------------------------------------- culling
    def cull_redundant(self) -> List[int]:
        """Remove keyframes whose odometry step is below the motion floor.

        A node is redundant when it has exactly two odometry links, no loop
        edge, and both relative motions are tiny (the stationary or
        slow-motion case). Composed edges keep the chain connected."""
        cfg = self.cfg
        g = self.graph
        culled = []
        for kf_id in list(g.slot_of.keys()):
            if g.fixed[g.slot_of[kf_id]]:
                continue
            edges = g.edges_of(kf_id)
            if len(edges) != 2 or any(g.edge_kind[e] == 1 for e in edges):
                continue
            small = all(
                np.linalg.norm(g.meas_r[e]) <= cfg.cull_min_translation
                and 2.0 * np.arccos(np.clip(abs(g.meas_q[e][3]), -1.0, 1.0)) <= cfg.cull_min_rotation
                for e in edges)
            if not small:
                continue
            g.remove_node(kf_id)
            self.db.remove(kf_id)
            if kf_id in self.insert_order:
                self.insert_order.remove(kf_id)
            culled.append(kf_id)
        return culled

    # ---------------------------------------------------------- trajectory
    def trajectory(self) -> List[Tuple[int, int, np.ndarray, np.ndarray]]:
        """(kf_id, timestamp_ns, r, q) for all live nodes, in insert order."""
        return [(kf_id, self.timestamps[kf_id], *self.graph.get_pose(kf_id))
                for kf_id in self.insert_order if self.graph.has_node(kf_id)]
