"""Debug visualization: keypoint overlays on camera images (port of
okvis_tpu.pipeline.visualizer).

The reference's VioVisualizer (okvis_multisensor_processing
VioVisualizer.cpp): draws keypoints into per-camera debug images with its
colour code: green = matched to an initialized 3D landmark, blue =
associated but 2D-only, red = unmatched/new detection. numpy only (no
OpenCV); returns RGB uint8 arrays an app can save as PNG.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

GREEN = np.asarray([0, 255, 0], np.uint8)
BLUE = np.asarray([80, 120, 255], np.uint8)
RED = np.asarray([255, 60, 60], np.uint8)


def _draw_circle(img: np.ndarray, x: float, y: float, radius: int, color: np.ndarray):
    H, W = img.shape[:2]
    xi, yi = int(round(x)), int(round(y))
    if not (0 <= xi < W and 0 <= yi < H):
        return
    y0, y1 = max(0, yi - radius), min(H, yi + radius + 1)
    x0, x1 = max(0, xi - radius), min(W, xi + radius + 1)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    ring = np.abs(np.hypot(yy - yi, xx - xi) - radius) < 0.8
    img[y0:y1, x0:x1][ring] = color


def draw_multiframe(multiframe, estimator=None, radius: int = 4) -> List[np.ndarray]:
    """Render per-camera overlays for a MultiFrame (frames must retain their
    images); keypoints come from the frames' host mirrors."""
    out = []
    for f in multiframe.frames:
        if f.image is None:
            out.append(None)
            continue
        gray = f.image.cpu().numpy() if isinstance(f.image, torch.Tensor) else np.asarray(f.image)
        rgb = np.repeat(gray[..., None].astype(np.uint8), 3, axis=-1)
        uv = f.uv_np
        for k in np.nonzero(f.mask_np)[0]:
            lm_id = int(f.landmark_ids[k])
            if lm_id == 0:
                color = RED
            elif estimator is not None and estimator.is_landmark_added(lm_id) and estimator.landmarks[lm_id].initialized:
                color = GREEN
            else:
                color = BLUE
            _draw_circle(rgb, uv[k, 0], uv[k, 1], radius, color)
        out.append(rgb)
    return out
