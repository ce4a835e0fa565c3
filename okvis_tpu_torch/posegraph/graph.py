"""Host-side pose-graph container: padded SoA numpy + id<->slot bookkeeping
(port of okvis_tpu.posegraph.graph).

Python dicts map keyframe ids to dense slots; numpy arrays padded to a
capacity that doubles when full are handed to the solver
(posegraph/optimize.py) as tensors on the graph's device. The slot layout,
free-slot reuse and growth are the JAX package's, so two graphs compare
slot for slot.

Edges store the measured relative transform ``T_ij = T_WS_i^-1 * T_WS_j``
and a 6x6 sqrt-information. ``remove_node`` supports redundant-keyframe
culling: the two odometry edges of the removed node are composed through
it (T_ik = T_ij * T_jk, with the weaker of the two informations) so the
chain stays connected.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kinematics import np_se3
from . import optimize as pgo


class PoseGraph:
    """Mutable pose graph over keyframe SE(3) poses. `device` is where
    to_arrays puts the solver's tensors: the CUDA card unless the caller
    passes device="cpu"."""

    def __init__(self, node_capacity: int = 256, edge_capacity: int = 512, dtype=np.float64, device=None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self._node_cap = node_capacity
        self._edge_cap = edge_capacity
        self.slot_of: Dict[int, int] = {}
        self.id_of: Dict[int, int] = {}
        self._free_slots: List[int] = []
        self.n_nodes = 0
        self.node_r = np.zeros((node_capacity, 3), dtype)
        self.node_q = np.zeros((node_capacity, 4), dtype)
        self.node_q[:, 3] = 1.0
        self.node_mask = np.zeros(node_capacity, bool)
        self.fixed = np.zeros(node_capacity, bool)
        # edges (SoA)
        self.n_edges = 0
        self.edge_i = np.zeros(edge_capacity, np.int32)
        self.edge_j = np.zeros(edge_capacity, np.int32)
        self.meas_r = np.zeros((edge_capacity, 3), dtype)
        self.meas_q = np.zeros((edge_capacity, 4), dtype)
        self.meas_q[:, 3] = 1.0
        self.sqrt_info = np.zeros((edge_capacity, 6, 6), dtype)
        self.edge_mask = np.zeros(edge_capacity, bool)
        self.edge_kind = np.zeros(edge_capacity, np.int8)  # 0 odom, 1 loop

    # ------------------------------------------------------------------ nodes
    def add_node(self, kf_id: int, r: np.ndarray, q: np.ndarray, fixed: bool = False) -> int:
        if kf_id in self.slot_of:
            raise ValueError(f"node {kf_id} already in graph")
        if self._free_slots:
            slot = self._free_slots.pop()
        else:
            if self.n_nodes >= self._node_cap:
                self._grow_nodes()
            slot = int(self.node_mask.sum() + len(self._free_slots))
            # first unoccupied slot from the end of the dense prefix
            while slot < self._node_cap and self.node_mask[slot]:
                slot += 1
        self.slot_of[kf_id] = slot
        self.id_of[slot] = kf_id
        self.node_r[slot] = r
        self.node_q[slot] = q
        self.node_mask[slot] = True
        self.fixed[slot] = fixed
        self.n_nodes += 1
        return slot

    def has_node(self, kf_id: int) -> bool:
        return kf_id in self.slot_of

    def get_pose(self, kf_id: int) -> Tuple[np.ndarray, np.ndarray]:
        s = self.slot_of[kf_id]
        return self.node_r[s].copy(), self.node_q[s].copy()

    def set_pose(self, kf_id: int, r: np.ndarray, q: np.ndarray) -> None:
        s = self.slot_of[kf_id]
        self.node_r[s] = r
        self.node_q[s] = q

    def set_fixed(self, kf_id: int, fixed: bool = True) -> None:
        self.fixed[self.slot_of[kf_id]] = fixed

    # ------------------------------------------------------------------ edges
    def add_edge(self, id_i: int, id_j: int, t_ij: np.ndarray, q_ij: np.ndarray, sqrt_info: np.ndarray,
                 kind: int = 0) -> int:
        return self._append_edge(self.slot_of[id_i], self.slot_of[id_j], t_ij, q_ij, sqrt_info, kind)

    def _append_edge(self, si: int, sj: int, t_ij, q_ij, sqrt_info, kind: int) -> int:
        if self.n_edges >= self._edge_cap:
            self._grow_edges()
        e = self.n_edges
        self.edge_i[e] = si
        self.edge_j[e] = sj
        self.meas_r[e] = t_ij
        self.meas_q[e] = q_ij
        self.sqrt_info[e] = sqrt_info
        self.edge_mask[e] = True
        self.edge_kind[e] = kind
        self.n_edges += 1
        return e

    def edges_of(self, kf_id: int) -> List[int]:
        s = self.slot_of[kf_id]
        live = np.nonzero(self.edge_mask[: self.n_edges])[0]
        return [int(e) for e in live if self.edge_i[e] == s or self.edge_j[e] == s]

    # ---------------------------------------------------------------- culling
    def remove_node(self, kf_id: int) -> None:
        """Cull a keyframe: compose its odometry chain through, drop its edges."""
        s = self.slot_of[kf_id]
        incident = self.edges_of(kf_id)
        odom = [e for e in incident if self.edge_kind[e] == 0]
        if len(odom) == 2:
            self._compose_through(s, *odom)
        for e in incident:
            self.edge_mask[e] = False
        self.node_mask[s] = False
        self.fixed[s] = False
        del self.slot_of[kf_id]
        del self.id_of[s]
        self._free_slots.append(s)
        self.n_nodes -= 1

    def _compose_through(self, s: int, e_a: int, e_b: int) -> None:
        """Replace edges (k—s) and (s—m) by one composed edge (k—m)."""

        def oriented(e):
            # (other_slot, T_other_s) with T measured other -> s
            if self.edge_j[e] == s:
                return int(self.edge_i[e]), (self.meas_r[e], self.meas_q[e])
            return int(self.edge_j[e]), np_se3.inverse(self.meas_r[e], self.meas_q[e])

        k, T_ks = oriented(e_a)
        m, T_ms = oriented(e_b)
        if k == m:
            return
        # T_km = T_ks * T_sm = T_ks * inverse(T_ms)
        T_sm = np_se3.inverse(*T_ms)
        r_km, q_km = np_se3.compose(T_ks[0], T_ks[1], T_sm[0], T_sm[1])
        # conservative information: the weaker of the two links
        Li = self.sqrt_info[e_a]
        Lj = self.sqrt_info[e_b]
        L = Li if np.trace(Li.T @ Li) < np.trace(Lj.T @ Lj) else Lj
        self._append_edge(k, m, r_km, q_km, L, 0)

    # ------------------------------------------------------------- growth
    def _grow(self, names, old_cap: int, q_name: str) -> int:
        new_cap = old_cap * 2
        for name in names:
            a = getattr(self, name)
            b = np.zeros((new_cap,) + a.shape[1:], a.dtype)
            b[:old_cap] = a
            if name == q_name:
                b[old_cap:, 3] = 1.0
            setattr(self, name, b)
        return new_cap

    def _grow_nodes(self) -> None:
        self._node_cap = self._grow(("node_r", "node_q", "node_mask", "fixed"), self._node_cap, "node_q")

    def _grow_edges(self) -> None:
        self._edge_cap = self._grow(("edge_i", "edge_j", "meas_r", "meas_q", "sqrt_info", "edge_mask", "edge_kind"),
                                    self._edge_cap, "meas_q")

    # -------------------------------------------------------------- solve
    def to_arrays(self, dtype=None) -> pgo.PoseGraphArrays:
        """The solver's tensors on the graph's device, in `dtype` (default:
        the graph's float type), with the per-node incidence table."""
        dt = getattr(torch, np.dtype(dtype or self.dtype).name)
        dev = self.device

        def t(a, d=None):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=d)

        return pgo.PoseGraphArrays(
            node_r=t(self.node_r, dt), node_q=t(self.node_q, dt), node_mask=t(self.node_mask),
            free_mask=t(self.node_mask & ~self.fixed), edge_i=t(self.edge_i, torch.int64),
            edge_j=t(self.edge_j, torch.int64), meas_r=t(self.meas_r, dt), meas_q=t(self.meas_q, dt),
            sqrt_info=t(self.sqrt_info, dt), edge_mask=t(self.edge_mask),
            incident=t(pgo.incidence_table(self.edge_i, self.edge_j, self.edge_mask, self._node_cap)))

    def optimize(self, max_iterations: int = 10, pcg_iters: int = 50, dtype=None,
                 solver: str = "auto") -> pgo.PgoResult:
        """Run the solver and write the occupied nodes' poses back into the
        container (one device-to-host copy). ``pcg_iters`` applies only when
        the resolved solver is "pcg"."""
        res = pgo.optimize_pose_graph(self.to_arrays(dtype), max_iterations=max_iterations, pcg_iters=pcg_iters,
                                      solver=solver)
        r = res.node_r.cpu().numpy().astype(self.dtype)
        q = res.node_q.cpu().numpy().astype(self.dtype)
        occ = self.node_mask
        self.node_r[occ] = r[occ]
        self.node_q[occ] = q[occ]
        return res
