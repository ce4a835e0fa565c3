"""Frontend orchestration, vision subset (port of okvis_tpu.frontend.frontend).

Ported so far: the configuration, gravity-aligned detection + description of
a whole multiframe in one batched call (single octave, no detection masks),
the choice of overlapping stereo pairs, and the launch half of stereo
matching: match + triangulate every overlapping pair and return the raw
results. Creating landmarks from them (``_resolve_stereo_pair``) needs the
estimator and waits for it, as do keyframe/last-frame association, RANSAC
and initialization.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kinematics as kin
from ..cameras.ncamera import NCameraSystem
from ..device import resolve_device
from . import kernels
from .brisk import detect_and_describe_batch, gravity_extraction_angle
from .frame import FrameData, MultiFrame


@dataclasses.dataclass
class FrontendConfig:
    detection_threshold: float = 30.0
    detection_octaves: int = 0  # >0 enables scale-space detection
    max_keypoints: int = 400
    matching_threshold: int = 60  # BRISK Hamming
    gate_radius_px: float = 40.0  # image-space gate for 3D-2D candidates
    keyframe_overlap: float = 0.6
    keyframe_ratio: float = 0.2
    num_matching_keyframes: int = 3  # match against the last 3 keyframes
    ransac_threshold_px2: float = 9.0
    min_3d2d_matches: int = 5  # tracking-failure warning level
    detection_masks: tuple = None  # optional per-camera (H, W) bool masks
    # below this correspondence count the 2D-2D relative model also runs the
    # 5-point solver
    fivepoint_max_corr: int = 24
    # added in quadrature to every keypoint gate stddev (uncalibrated rig
    # during online extrinsics estimation); 0 when extrinsics are fixed
    gate_extra_px: float = 0.0


# (ca, cb, assign (K,), hp_W (K,4), valid (K,), parallel (K,), can_init (K,))
StereoResult = Tuple[int, int, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class Frontend:
    """Host-side frontend; device work runs on the rig's device."""

    def __init__(self, rig: NCameraSystem, cfg: FrontendConfig = None):
        self.rig = rig
        self.cfg = cfg or FrontendConfig()
        self.device = resolve_device(rig.device)

    def _extraction_angles(self, T_WS: Optional[kin.SE3], C: int) -> torch.Tensor:
        """Per-camera angle of gravity projected into the image (float32)."""
        if T_WS is None:
            return torch.zeros(C, dtype=torch.float32, device=self.device)
        T_WC = kin.compose(
            kin.SE3(r=T_WS.r[None], q=T_WS.q[None]),
            kin.SE3(r=self.rig.T_SC.r[:C], q=self.rig.T_SC.q[:C]),
        )
        down = T_WC.q.new_tensor([0.0, 0.0, -1.0])
        g_C = kin.quat_rotate(kin.quat_conjugate(T_WC.q), down)
        return gravity_extraction_angle(g_C).to(torch.float32)

    def detect_and_describe_multi(self, images, T_WS: Optional[kin.SE3] = None) -> List[FrameData]:
        """All cameras of a multiframe in one batched call, with gravity-aligned
        per-camera extraction angles. `images` are (H, W) arrays or tensors."""
        if self.cfg.detection_octaves > 0 or self.cfg.detection_masks is not None:
            raise NotImplementedError(
                "okvis_tpu_torch: scale-space and masked detection are not ported yet")
        C = len(images)
        stack = torch.stack(
            [torch.as_tensor(im, dtype=torch.float32, device=self.device) for im in images])
        kps_b, desc_b = detect_and_describe_batch(
            stack,
            self._extraction_angles(T_WS, C),
            threshold=self.cfg.detection_threshold,
            max_keypoints=self.cfg.max_keypoints,
        )
        # one joint host copy of every camera's uv/mask mirrors — the
        # association path reads them many times
        uv_h = kps_b.uv.cpu().numpy()
        mask_h = kps_b.mask.cpu().numpy()
        out = []
        for c in range(C):
            fd = FrameData(
                keypoints=_camera_slice(kps_b, c),
                descriptors=desc_b[c],
                landmark_ids=np.zeros(self.cfg.max_keypoints, np.int64),
                image=stack[c],
            )
            fd.set_host_mirrors(uv_h[c], mask_h[c])
            out.append(fd)
        return out

    def _stereo_pairs(self, C: int):
        return tuple(
            (ca, cb)
            for ca in range(C)
            for cb in range(ca + 1, C)
            if self.rig.overlaps is None or self.rig.has_overlap(ca, cb)
        )

    def _kp_std(self, f: FrameData) -> np.ndarray:
        """Keypoint stddev [px]: 0.8/12 · size, with the optional gate inflation."""
        K = self.cfg.max_keypoints
        s = 0.8 / 12.0 * (np.asarray(f.sizes)[:K] if f.sizes is not None else np.full(K, 8.0))
        if self.cfg.gate_extra_px > 0.0:
            s = np.sqrt(s**2 + self.cfg.gate_extra_px**2)
        return s

    def match_stereo(self, multiframe: MultiFrame, T_WS: kin.SE3) -> List[StereoResult]:
        """Stereo matching + triangulation of every overlapping camera pair of
        a multiframe at body pose T_WS — the launch half of the JAX package's
        ``Frontend._match_stereo``, with extrinsics and intrinsics read from
        the rig. Keypoints already carrying a landmark id are not matched.
        Geometry runs in the rig's dtype. Returns one host result per pair."""
        dtype = self.rig.dtype
        results = []
        for ca, cb in self._stereo_pairs(multiframe.num_cameras):
            fa, fb = multiframe.frames[ca], multiframe.frames[cb]
            free_a = fa.mask_np & (fa.landmark_ids == 0)
            free_b = fb.mask_np & (fb.landmark_ids == 0)
            if not free_a.any() or not free_b.any():
                continue
            T_WC_a = kin.compose(T_WS, self.rig.camera_T_SC(ca))
            T_WC_b = kin.compose(T_WS, self.rig.camera_T_SC(cb))

            def dev(x, dt=dtype):
                return torch.as_tensor(x, dtype=dt, device=self.device)

            out = kernels.stereo_match_triangulate(
                self.rig.specs[ca],
                self.rig.specs[cb],
                self.rig.intrinsics[ca],
                self.rig.intrinsics[cb],
                fa.descriptors,
                fb.descriptors,
                dev(free_a, torch.bool),
                dev(free_b, torch.bool),
                fa.keypoints.uv.to(dtype),
                fb.keypoints.uv.to(dtype),
                T_WC_a,
                T_WC_b,
                dev(self._kp_std(fa)),
                dev(self._kp_std(fb)),
                threshold=self.cfg.matching_threshold,
            )
            results.append((ca, cb, *(t.cpu().numpy() for t in out)))
        return results


def _camera_slice(kps, c: int):
    """Camera c's slice of a batched Keypoints."""
    return type(kps)(*(t[c] for t in kps))
