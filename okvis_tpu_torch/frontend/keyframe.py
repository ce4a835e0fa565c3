"""Keyframe insertion heuristic: convex-hull overlap + matching ratio (a copy of
okvis_tpu.frontend.keyframe).

Re-derivation of the reference Frontend::doWeNeedANewKeyframe
(okvis_frontend/src/Frontend.cpp:295-369): per camera, the convex hull of
landmark-matched keypoints against the hull of all keypoints gives an
overlap area fraction; the matching ratio counts matches over keypoints
inside the match hull. No new keyframe when overlap > 0.6 AND ratio > 0.2.

Runs on the host in numpy (monotone-chain hull and shoelace area replace
cv::convexHull / contourArea / pointPolygonTest).
"""

from __future__ import annotations

from typing import List

import numpy as np


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; points (N,2) -> hull vertices CCW (M,2)."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(u, v):
        return u[0] * v[1] - u[1] * v[0]

    def half(iterable):
        h = []
        for p in iterable:
            while len(h) >= 2 and cross2(h[-1] - h[-2], p - h[-2]) <= 0:
                h.pop()
            h.append(p)
        return h

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def polygon_area(hull: np.ndarray) -> float:
    """Shoelace area of a CCW polygon."""
    if len(hull) < 3:
        return 0.0
    x, y = hull[:, 0], hull[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def points_in_polygon(points: np.ndarray, hull: np.ndarray) -> np.ndarray:
    """Strict-interior test (matches cv::pointPolygonTest(...) > 0), vectorized
    winding check for a convex CCW hull."""
    if len(hull) < 3:
        return np.zeros(len(points), bool)
    a = hull
    b = np.roll(hull, -1, axis=0)
    # cross((b-a), (p-a)) > 0 for every edge -> strictly inside
    d = (b - a)[None, :, :]  # (1, M, 2)
    w = points[:, None, :] - a[None, :, :]  # (N, M, 2)
    cross = d[..., 0] * w[..., 1] - d[..., 1] * w[..., 0]
    return np.all(cross > 0, axis=1)


def need_new_keyframe(
    keypoints_per_cam: List[np.ndarray],  # [(Ni, 2)] all keypoints
    matched_mask_per_cam: List[np.ndarray],  # [(Ni,)] has-landmark flags
    overlap_threshold: float = 0.6,
    ratio_threshold: float = 0.2,
    num_frames: int = 2,
    is_initialized: bool = True,
) -> bool:
    if num_frames < 2:
        return True
    if not is_initialized:
        return False
    overlap, ratio = 0.0, 0.0
    for pts, matched in zip(keypoints_per_cam, matched_mask_per_cam):
        if len(pts) < 3:
            continue
        m_pts = pts[matched]
        if len(m_pts) < 3:
            continue
        hull_all = convex_hull(pts)
        hull_m = convex_hull(m_pts)
        area_all = polygon_area(hull_all)
        area_m = polygon_area(hull_m)
        if area_all <= 0:
            continue
        overlap = max(overlap, area_m / area_all)
        n_inside = int(points_in_polygon(pts, hull_m).sum())
        if n_inside > 0:
            ratio = max(ratio, len(m_pts) / n_inside)
    return not (overlap > overlap_threshold and ratio > ratio_threshold)
