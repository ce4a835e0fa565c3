"""Frame / MultiFrame containers: fixed-capacity keypoint storage
(port of okvis_tpu.frontend.frame).

Every camera's keypoints live in padded tensors (uv, score, packed
descriptors, validity mask) of capacity `max_keypoints`, plus a host-side
landmark-id array (0 = unassociated).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .detection import Keypoints


@dataclasses.dataclass
class FrameData:
    """One camera's detections in a multiframe.

    uv/mask host mirrors are cached: one joint device-to-host copy, made by
    the detection stage, serves every later host read."""

    keypoints: Keypoints  # uv (K,2), score (K,), mask (K,)
    descriptors: torch.Tensor  # (K, 16) int32 bit patterns
    landmark_ids: np.ndarray  # (K,) int64 host array; 0 = none
    image: Optional[torch.Tensor] = None  # (H, W) retained for visualization
    sizes: Optional[np.ndarray] = None  # (K,) keypoint size (octave-scaled)
    _uv_np: Optional[np.ndarray] = None
    _mask_np: Optional[np.ndarray] = None

    def _fetch_host(self) -> None:
        self._uv_np = self.keypoints.uv.cpu().numpy()
        self._mask_np = self.keypoints.mask.cpu().numpy().astype(bool)

    @property
    def uv_np(self) -> np.ndarray:
        if self._uv_np is None:
            self._fetch_host()
        return self._uv_np

    @property
    def mask_np(self) -> np.ndarray:
        if self._mask_np is None:
            self._fetch_host()
        return self._mask_np

    def set_host_mirrors(self, uv: np.ndarray, mask: np.ndarray) -> None:
        self._uv_np = np.asarray(uv)
        self._mask_np = np.asarray(mask, bool)

    def keypoint_size(self, k: int) -> float:
        return float(self.sizes[k]) if self.sizes is not None else 8.0

    @property
    def num_keypoints(self) -> int:
        return int(self.mask_np.sum())


@dataclasses.dataclass
class MultiFrame:
    """Synchronized bundle of per-camera frames."""

    id: int
    timestamp: float  # seconds
    frames: List[FrameData]

    @property
    def num_cameras(self) -> int:
        return len(self.frames)

    def landmark_id(self, cam: int, k: int) -> int:
        return int(self.frames[cam].landmark_ids[k])

    def set_landmark_id(self, cam: int, k: int, lm_id: int) -> None:
        self.frames[cam].landmark_ids[k] = lm_id

    def keypoint(self, cam: int, k: int) -> np.ndarray:
        return self.frames[cam].uv_np[k]
