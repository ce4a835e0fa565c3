"""Headless PoseViewer: top-down trajectory rendering to RGB arrays/PNG
(port of okvis_tpu.pipeline.pose_viewer).

The reference's PoseViewer (okvis_apps okvis_app_synchronous.cpp:55-195)
draws a live cv2 window with the x-y path, an auto-scaling frame, a metric
scale bar, and the current speed/height readout. Here the same drawing goes
into a numpy RGB image an app can save as PNG (save imports PIL, nothing
else does). numpy only: no OpenCV, no display.

Usage mirrors the reference's publishFullStateAsCallback: register
``viewer.publish_full_state_as_callback`` as the pipeline's
``full_state_callback``, then ``viewer.render()`` / ``viewer.save(path)``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

_BG = np.asarray([255, 255, 255], np.uint8)
_PATH = np.asarray([40, 80, 220], np.uint8)
_LOOP_PATH = np.asarray([30, 160, 60], np.uint8)
_TEXTC = np.asarray([0, 0, 0], np.uint8)


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


def _draw_line(img: np.ndarray, p0, p1, color: np.ndarray, thickness: int = 1):
    """Integer Bresenham-ish line via dense interpolation (tiny images)."""
    H, W = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    xs = np.linspace(p0[0], p1[0], n)
    ys = np.linspace(p0[1], p1[1], n)
    for t in range(-(thickness // 2), thickness // 2 + 1):
        xi = np.clip(np.round(xs).astype(int) + t, 0, W - 1)
        yi = np.clip(np.round(ys).astype(int), 0, H - 1)
        img[yi, xi] = color
        xi = np.clip(np.round(xs).astype(int), 0, W - 1)
        yi = np.clip(np.round(ys).astype(int) + t, 0, H - 1)
        img[yi, xi] = color


class PoseViewer:
    """Accumulates T_WS positions; renders the x-y path like the reference.

    The reference's auto-rescale behavior (``_scale`` shrink-to-fit,
    okvis_app_synchronous.cpp:92-121) is reproduced: the view expands when
    the path approaches the border.
    """

    def __init__(self, image_size: int = 620, frame_margin: int = 40):
        self.size = image_size
        self.margin = min(frame_margin, image_size // 4)
        self.path: List[np.ndarray] = []
        self.loop_path: List[np.ndarray] = []
        self.speeds: List[float] = []
        self.heights: List[float] = []

    # callback-compatible with ThreadedVio.full_state_callback
    def publish_full_state_as_callback(self, timestamp_ns, T_WS,
                                       speed_and_bias, *_) -> None:
        r = _host(T_WS.r if hasattr(T_WS, "r") else T_WS)
        self.path.append(r[:3].copy())
        sb = _host(speed_and_bias)
        self.speeds.append(float(np.linalg.norm(sb[:3])))
        self.heights.append(float(r[2]))

    def add_loop_corrected(self, positions: np.ndarray) -> None:
        """Optional second (loop-corrected) path drawn in green."""
        self.loop_path = [np.asarray(p, np.float64) for p in positions]

    def _bounds(self) -> Tuple[np.ndarray, float]:
        pts = np.asarray(self.path)[:, :2]
        if len(self.loop_path):
            pts = np.concatenate([pts, np.asarray(self.loop_path)[:, :2]])
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        center = 0.5 * (lo + hi)
        extent = float(np.max(hi - lo))
        # shrink-to-fit with head-room, like the reference's _scale update
        scale = (self.size - 2 * self.margin) / max(extent, 1e-6)
        return center, min(scale, 200.0)

    def _to_px(self, p, center, scale) -> Tuple[float, float]:
        x = self.size / 2 + (p[0] - center[0]) * scale
        y = self.size / 2 - (p[1] - center[1]) * scale
        return x, y

    def render(self) -> np.ndarray:
        img = np.full((self.size, self.size, 3), _BG, np.uint8)
        if len(self.path) < 2:
            return img
        center, scale = self._bounds()
        for seq, color in ((self.path, _PATH), (self.loop_path, _LOOP_PATH)):
            for a, b in zip(seq[:-1], seq[1:]):
                _draw_line(img, self._to_px(a, center, scale),
                           self._to_px(b, center, scale), color, thickness=2)
        # metric scale bar (reference draws a 1 m bar bottom-left)
        bar_m = 10.0 ** np.floor(np.log10((self.size / 4) / scale))
        bar_px = bar_m * scale
        y0 = self.size - self.margin // 2
        _draw_line(img, (self.margin, y0), (self.margin + bar_px, y0),
                   _TEXTC, thickness=3)
        return img

    def save(self, path: str) -> None:
        from PIL import Image

        Image.fromarray(self.render()).save(path)

    def last_readout(self) -> Optional[dict]:
        """Speed / height of the newest state (the reference's cv2.putText)."""
        if not self.path:
            return None
        return {"speed_mps": self.speeds[-1], "height_m": self.heights[-1],
                "n_states": len(self.path)}
