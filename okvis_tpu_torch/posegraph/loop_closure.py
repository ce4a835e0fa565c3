"""Geometric verification of loop candidates -> relative-pose constraints
(port of okvis_tpu.posegraph.loop_closure).

A retrieval hit (place_recognition.py) is verified the way the reference
frontend verifies 3D-2D associations (okvis_frontend Frontend.cpp:575-642
runRansac3d2d): the candidate keyframe's landmark-bearing descriptors are
matched against the query's (the Hamming kernel and the auction
assignment), then absolute-pose RANSAC (frontend/ransac.py) runs on the
candidate's landmark positions against the query's bearings.

The measurement is the relative transform ``T_cand_query = T_WS_cand^-1 *
T_WS_query^meas``, locally drift-free because the candidate's landmarks are
consistent with its own pose estimate. Its information grows with the
inlier count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..frontend import ransac
from ..kinematics import np_se3
from ..ops import hamming
from ..utils import syncstats

N_HYP = 128  # RANSAC hypotheses of a verification: the uniforms are (N_HYP, 3)


class LoopVerification(NamedTuple):
    success: torch.Tensor  # () bool
    num_inliers: torch.Tensor  # () int
    num_matches: torch.Tensor  # () int
    R_CW: torch.Tensor  # (3, 3) rotation world -> query camera
    t_C: torch.Tensor  # (3,) translation (query camera frame)


def verify_loop_candidate(
    u: torch.Tensor,  # (n_hyp, 3) uniform draws of the RANSAC samples
    desc_c: torch.Tensor,  # (Kc, 16) int32 candidate keyframe descriptors
    lm_mask_c: torch.Tensor,  # (Kc,) candidate keypoint has a 3D landmark
    landmarks_W: torch.Tensor,  # (Kc, 3) landmark positions (world)
    desc_q: torch.Tensor,  # (Kq, 16) int32 query descriptors
    mask_q: torch.Tensor,  # (Kq,)
    bearings_q: torch.Tensor,  # (Kq, 3) unit bearings in the query camera frame
    focal: float = 460.0,
    match_threshold: int = 60,
    min_inliers: int = 20,
    threshold_px2: float = 9.0,
) -> LoopVerification:
    """Gated matching and absolute-pose RANSAC, without a host read."""
    match = hamming.match_descriptors(desc_c, desc_q, lm_mask_c, mask_q, threshold=match_threshold)  # (Kc,)
    matched = match >= 0
    brg_q = bearings_q[torch.where(matched, match, 0)]  # (Kc, 3) aligned with the candidate's rows
    pair_mask = matched & lm_mask_c
    res = ransac.ransac_absolute_pose(u, landmarks_W, brg_q, pair_mask, focal=focal, threshold_px2=threshold_px2)
    M = res.model.reshape(3, 4)
    return LoopVerification(success=res.success & (res.num_inliers >= min_inliers), num_inliers=res.num_inliers,
                            num_matches=torch.sum(pair_mask), R_CW=M[:, :3], t_C=M[:, 3])


def relative_pose_from_verification(
    ver: LoopVerification,
    T_WS_cand: Tuple[np.ndarray, np.ndarray],
    T_SC: Tuple[np.ndarray, np.ndarray],
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Host epilogue: turn (R_CW, t_C) into the edge measurement T_cand_query.

    p_C = R_CW p_W + t  =>  T_CW = (t, R_CW); T_WC = T_CW^-1;
    T_WS_query = T_WC * T_SC^-1; edge = T_WS_cand^-1 * T_WS_query.
    One host read of the model (syncstats `posegraph_verify`)."""
    with syncstats.sync("posegraph_verify"):
        model = torch.cat([ver.R_CW.reshape(-1), ver.t_C, ver.success.reshape(1).to(ver.t_C.dtype)]).cpu().numpy()
    if not model[12]:
        return None
    R_CW = np.asarray(model[:9].reshape(3, 3), np.float64)
    t_C = np.asarray(model[9:12], np.float64)
    q_CW = np_se3.matrix_to_quat(R_CW)
    r_WC, q_WC = np_se3.inverse(t_C, q_CW)
    r_CS, q_CS = np_se3.inverse(*T_SC)
    r_WSq, q_WSq = np_se3.compose(r_WC, q_WC, r_CS, q_CS)
    r_SWc, q_SWc = np_se3.inverse(*T_WS_cand)
    return np_se3.compose(r_SWc, q_SWc, r_WSq, q_WSq)


def loop_edge_sqrt_info(num_inliers: int, sigma_t: float = 0.03, sigma_r: float = 0.01,
                        ref_inliers: int = 30) -> np.ndarray:
    """6x6 sqrt-information for a loop edge, stiffer with more inliers.

    At ~30 inliers with sub-pixel reprojection consistency at EuRoC scale
    (depth ~5 m, f ~460 px) the relative pose is good to a few centimetres
    and ~0.5 deg."""
    s = np.sqrt(max(num_inliers, 1) / ref_inliers)
    w = np.concatenate([np.full(3, s / sigma_t), np.full(3, s / sigma_r)])
    return np.diag(w)
