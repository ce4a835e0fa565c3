"""N-camera rig: per-camera extrinsics + geometry + pairwise FOV overlap masks
(port of okvis_tpu.cameras.ncamera).

Camera specs are static; intrinsics and extrinsics are tensors on the rig's
device. The overlap computation is the reference's per-pixel ray casting,
vectorized: one batched backproject → rotate-at-infinity → project per camera
pair.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..kinematics import SE3, compose, inverse, quat_rotate
from . import pinhole
from .pinhole import CameraSpec


@dataclasses.dataclass
class NCameraSystem:
    """Camera rig. T_SC[i] maps camera-i coordinates into the IMU/sensor frame S."""

    specs: Tuple[CameraSpec, ...]
    T_SC: SE3  # batched: r (N,3), q (N,4)
    intrinsics: List[torch.Tensor]  # per camera (4+K_i,) — K varies by model
    overlaps: np.ndarray = None  # (N, N) bool, computed by compute_overlaps
    overlap_mats: list = None  # [seen_by][cam] -> (H, W) bool or None

    @property
    def num_cameras(self) -> int:
        return len(self.specs)

    @property
    def device(self) -> torch.device:
        return self.T_SC.r.device

    @property
    def dtype(self) -> torch.dtype:
        return self.T_SC.r.dtype

    def camera_T_SC(self, i: int) -> SE3:
        return SE3(r=self.T_SC.r[i], q=self.T_SC.q[i])

    def has_overlap(self, cam_a: int, cam_b: int) -> bool:
        if self.overlaps is None:
            return False
        return bool(self.overlaps[cam_a][cam_b])

    def compute_overlaps(self, stride: int = 8) -> None:
        """Pairwise FOV overlap by ray casting every `stride`-th pixel of each
        camera into each other camera (rotation only: points at infinity),
        with a backprojection ray-consistency check; the coarse mask is
        upsampled back to full resolution."""
        n = self.num_cameras
        self.overlaps = np.zeros((n, n), dtype=bool)
        self.overlap_mats = [[None] * n for _ in range(n)]
        for seen_by in range(n):
            for cam in range(n):
                spec = self.specs[cam]
                if seen_by == cam:
                    self.overlaps[seen_by][cam] = True
                    self.overlap_mats[seen_by][cam] = np.ones((spec.height, spec.width), dtype=bool)
                    continue
                other = self.specs[seen_by]
                intr = self.intrinsics[cam]
                T_Co_C = compose(inverse(self.camera_T_SC(seen_by)), self.camera_T_SC(cam))
                us = torch.arange(0, spec.width, stride, dtype=intr.dtype, device=intr.device)
                vs = torch.arange(0, spec.height, stride, dtype=intr.dtype, device=intr.device)
                vv, uu = torch.meshgrid(vs, us, indexing="ij")
                uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1)
                rays = pinhole.back_project(spec, intr, uv)
                rays_o = quat_rotate(T_Co_C.q[None, :], rays)
                uv_o, flags = pinhole.project(other, self.intrinsics[seen_by], rays_o)
                ok = flags == pinhole.STATUS_OK
                # ray consistency (guards distortion-model artifacts)
                ver = pinhole.back_project(other, self.intrinsics[seen_by], uv_o)
                a = rays_o / torch.linalg.norm(rays_o, dim=-1, keepdim=True)
                b = ver / torch.linalg.norm(ver, dim=-1, keepdim=True)
                ok = ok & ((torch.sum(a * b, dim=-1) - 1.0).abs() < 1e-6)
                mask_small = ok.cpu().numpy().reshape(len(vs), len(us))
                mask = np.kron(mask_small, np.ones((stride, stride), dtype=bool))
                self.overlap_mats[seen_by][cam] = mask[: spec.height, : spec.width]
                self.overlaps[seen_by][cam] = bool(mask_small.any())


def make_stereo_rig(
    specs: Sequence[CameraSpec],
    T_SC_list: Sequence[SE3],
    intrinsics_list: Sequence[torch.Tensor],
    compute_overlaps: bool = True,
) -> NCameraSystem:
    rig = NCameraSystem(
        specs=tuple(specs),
        T_SC=SE3(r=torch.stack([T.r for T in T_SC_list]), q=torch.stack([T.q for T in T_SC_list])),
        intrinsics=list(intrinsics_list),
    )
    if compute_overlaps:
        rig.compute_overlaps()
    return rig
