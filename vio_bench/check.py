"""The comparison that decides `correct`: what the timed window produced,
against the plain reference (`vio_bench/reference/`), each number beside
the limit that `limits/<cell>.json` sets for it.

- `keypoints_unmatched`: over the sampled frames' images, the share of the
  program's and the reference's keypoints that have no partner within
  0.001 px on the other side;
- `descriptor_bits_differ`: over the matched keypoints, the share of the
  512 descriptor bits that differ from the reference's (the pattern turned
  by the angle of gravity under the pose the program predicted for the
  frame: the one input the reference takes from the program's state, whose
  accuracy `ate_m` judges);
- `hamming_entries_differ`: over the sampled distance matrices the
  association and stereo matching used, the entries that differ from the
  reference's XOR and popcount of the same descriptors and masks (exact);
- `ate_m`: the published trajectory's RMS position error against the truth
  after an SE(3) alignment;
- `rot_err_deg`: the published trajectory's RMS orientation error against
  the truth after aligning the yaw about gravity, the one rotation that
  visual-inertial odometry cannot observe.

Where the configuration runs the pose-graph layer, five more:

- `posegraph_scores_differ`: over the sampled keyframe retrievals, the
  database score entries, and the best slots, that differ from the
  reference's XOR, popcount and votes over the same query and database
  (exact: a score is a ratio of two counts, rounded once to float32);
- `loop_edge_err_m`, `loop_edge_err_deg`: the RMS position and rotation
  error of every loop edge accepted in the window against the true
  relative pose T_WS_cand^-1 T_WS_query at the two keyframes' stamps
  (None, so not correct, where the window accepted no loop);
- `posegraph_solve_err_m`, `posegraph_solve_err_rad`: over the sampled
  solves, the largest position and rotation difference between the poses
  the program wrote back and the reference's float64 Levenberg-Marquardt
  solve from the same graph.
"""

from __future__ import annotations

import numpy as np
import torch

from . import world
from .reference import detect, geometry, hamming, posegraph

MATCH_PX = 1e-3


def match_keypoints(uv_p: np.ndarray, uv_r: np.ndarray) -> tuple:
    """(pairs [(i_program, j_reference)], unmatched count on both sides):
    mutual nearest neighbours closer than MATCH_PX."""
    if len(uv_p) == 0 or len(uv_r) == 0:
        return [], len(uv_p) + len(uv_r)
    d = np.linalg.norm(uv_p[:, None, :].astype(np.float64) - uv_r[None, :, :].astype(np.float64), axis=-1)
    jp, ir = d.argmin(1), d.argmin(0)
    pairs = [(i, j) for i, j in enumerate(jp) if ir[j] == i and d[i, j] < MATCH_PX]
    return pairs, len(uv_p) + len(uv_r) - 2 * len(pairs)


def reference_detection(img: np.ndarray, threshold: float, max_keypoints: int) -> np.ndarray:
    return detect.keypoints(torch.as_tensor(img, dtype=torch.float32)[None], threshold, max_keypoints)[0].numpy()


def detection_numbers(detections: list, stream: world.Stream, config: dict, describe=None) -> tuple:
    """(keypoints_unmatched, descriptor_bits_differ) over the sampled frames.
    `describe(img, uv, angle)` gives the descriptors that are judged against
    the reference's (default: the program's own, as recorded)."""
    det = config["detection_options"]
    unmatched = total = bits = compared = 0
    for n, q, cams in detections:
        angles = np.zeros(len(cams), np.float32) if q is None else detect.gravity_angles(q, stream.T_SC)
        for c, (uv, mask, desc) in enumerate(cams):
            img = stream.frame_images(n)[c]
            uv_r = reference_detection(img, det["threshold"], det["maxNoKeypoints"])
            valid = np.nonzero(mask)[0]
            pairs, miss = match_keypoints(uv[valid], uv_r)
            unmatched += miss
            total += len(valid) + len(uv_r)
            if not pairs:
                continue
            ip = valid[[i for i, _ in pairs]]
            jr = np.asarray([j for _, j in pairs])
            ref = detect.describe(torch.as_tensor(img, dtype=torch.float32), torch.from_numpy(uv_r[jr]),
                                  float(angles[c])).numpy()
            got = desc[ip] if describe is None else describe(img, uv_r[jr], float(angles[c]))
            x = np.bitwise_xor(np.ascontiguousarray(got).view(np.uint8), np.ascontiguousarray(ref).view(np.uint8))
            bits += int(np.unpackbits(x).sum())
            compared += got.size * 32
    return (unmatched / total if total else None), (bits / compared if compared else None)


def _batched(x, ndim: int):
    return None if x is None else (x if x.ndim == ndim else x[None])


def hamming_number(samples: list) -> int:
    differ = 0
    for a, b, ma, mb, out in samples:
        ref = hamming.distances(_batched(a, 3), _batched(b, 3), _batched(ma, 2), _batched(mb, 2))
        got = _batched(out, 3)
        differ += int((ref != got).sum()) if ref.shape == got.shape else got.size
    return differ


def trajectory_numbers(outputs, stream: world.Stream) -> tuple:
    """(ate_m, rot_err_deg) of the published trajectory, or Nones for fewer
    than four states."""
    ts, r, q = outputs.trajectory
    if len(ts) < 4:
        return None, None
    true_r, true_R, _ = stream.truth(ts)
    return geometry.ate(r, true_r), geometry.orientation_error_deg(geometry.quat_to_rot(q), true_R)


def scores_number(retrievals: list) -> int:
    """Score entries and best slots of the sampled retrievals that differ
    from the reference's."""
    differ = 0
    for r in retrievals:
        ref, best = posegraph.scores(r["desc_q"], r["mask_q"], r["db_desc"], r["db_mask"], r["slots"], r["allowed"],
                                     len(r["allowed"]), r["vote_threshold"])
        differ += int((ref != r["scores"]).sum()) + int(best != r["best"])
    return differ


def loop_edge_numbers(edges: list, stream: world.Stream) -> tuple:
    """(RMS position error m, RMS rotation error deg) of loop edges
    (stamp_cand, stamp_query, r, q) against the truth, or Nones for none."""
    if not edges:
        return None, None
    t_c, t_q, r, q = (np.asarray(x) for x in zip(*edges))
    pc, Rc, _ = stream.truth(t_c)
    pq, Rq, _ = stream.truth(t_q)
    true_r = np.einsum("nji,nj->ni", Rc, pq - pc)  # R_c^T (p_q - p_c)
    true_R = np.swapaxes(Rc, -1, -2) @ Rq
    err_r = np.linalg.norm(r - true_r, axis=-1)
    err_a = geometry.rotation_angle(np.swapaxes(geometry.quat_to_rot(q), -1, -2) @ true_R)
    return float(np.sqrt((err_r ** 2).mean())), float(np.degrees(np.sqrt((err_a ** 2).mean())))


def reference_solve(item: dict, dtype=torch.float64) -> tuple:
    """The reference's poses (r, q) for a sampled solve: from the graph as
    the program's call found it, with the call's iteration count."""
    return posegraph.solve(**item["before"], max_iterations=item["kwargs"].get("max_iterations", 10), dtype=dtype)


def solve_numbers(solves: list) -> tuple:
    """(largest position difference m, largest rotation difference rad)
    between the sampled solves' poses and the reference's from the same
    graph, over the occupied nodes; Nones for no solve."""
    if not solves:
        return None, None
    worst_m = worst_rad = 0.0
    for item in solves:
        r, q = reference_solve(item)
        occ = item["before"]["node_mask"]
        dm, drad = posegraph.pose_differences(item["node_r"][occ], item["node_q"][occ], r[occ], q[occ])
        worst_m, worst_rad = max(worst_m, dm), max(worst_rad, drad)
    return worst_m, worst_rad


def posegraph_values(pg: dict, stream: world.Stream) -> dict:
    edge_m, edge_deg = loop_edge_numbers(pg["loop_edges"], stream)
    solve_m, solve_rad = solve_numbers(pg["solves"])
    return dict(posegraph_scores_differ=scores_number(pg["retrievals"]) if pg["retrievals"] else None,
                loop_edge_err_m=edge_m, loop_edge_err_deg=edge_deg,
                posegraph_solve_err_m=solve_m, posegraph_solve_err_rad=solve_rad)


def compare(outputs, stream: world.Stream, config: dict, limits: dict) -> dict:
    kp, bits = detection_numbers(outputs.detections, stream, config)
    ate, rot = trajectory_numbers(outputs, stream)
    values = dict(keypoints_unmatched=kp, descriptor_bits_differ=bits,
                  hamming_entries_differ=hamming_number(outputs.hamming) if outputs.hamming else None,
                  ate_m=ate, rot_err_deg=rot)
    if outputs.posegraph is not None:
        values.update(posegraph_values(outputs.posegraph, stream))
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
