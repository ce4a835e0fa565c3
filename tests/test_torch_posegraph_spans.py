"""The pose-graph layer's Timers and spans (okvis_tpu_torch.posegraph.manager,
ThreadedVio._feed_posegraph): `posegraph.feed`, `.query`, `.verify`,
`.solve` and `.insert` under each keyframe's `3.3 posegraph`, their counts
as the layer's counters, their attributes, and what they leave alone.
Imports no JAX.

The port's ThreadedVio runs tests/test_torch_posegraph_runtime.py's set-up
in float64 on the CPU: 9 stub frames (K = 64) with the pose graph on,
min_gap 1, node capacity 64 and edge capacity 128, and the frontend's
keyframe overlap raised to 0.95, so that most frames are keyframes and
candidates are verified. It runs traced, untraced, and untraced with the
layer off.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from okvis_tpu_torch import convert
from okvis_tpu_torch.cameras.ncamera import NCameraSystem
from okvis_tpu_torch.config import VioParameters
from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, keypoint_frames, make_landmarks, simulate_trajectory
from okvis_tpu_torch.pipeline import ThreadedVio
from okvis_tpu_torch.utils import syncstats
from okvis_tpu_torch.utils.ids import IdProvider
from okvis_tpu_torch.utils.timing import Timing

torch.set_num_threads(2)
N_FRAMES, K = 9, 64
KEYFRAME_OVERLAP = 0.95
LAYER = ("posegraph.feed", "posegraph.query", "posegraph.verify", "posegraph.solve", "posegraph.insert")


def _run(traced: bool, posegraph: bool = True) -> dict:
    """N_FRAMES keypoint frames through a float64 CPU ThreadedVio behind a
    stub detector: its export, the syncstats deltas, the Timing counts, the
    trajectory, the loop events and the graph's poses."""
    traj = simulate_trajectory(duration=1.2, seed=31, motion_scale=0.25)
    lms = make_landmarks(traj, 600, seed=32, radius=(4.0, 8.0))
    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    rig = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)
    rig.compute_overlaps()
    frames = iter(keypoint_frames(traj, lms, rig, N_FRAMES, K, seed=3))
    params = VioParameters()
    params.optimization.max_num_keypoints = K
    params.posegraph.enabled = posegraph
    params.posegraph.min_gap = 1
    params.posegraph.node_capacity = 64
    params.posegraph.edge_capacity = 128
    IdProvider.reset()
    vio = ThreadedVio(params, rig=rig, blocking=True, dtype=torch.float64, device="cpu")
    vio.frontend.cfg.keyframe_overlap = KEYFRAME_OVERLAP

    def detect(images, T_WS=None):
        f = next(frames)
        return [convert.frame_from_numpy(f.uv[c], np.ones(K), f.mask[c], f.descriptors[c], np.zeros(K, np.int64),
                                         device="cpu", dtype=torch.float64) for c in range(len(images))]

    vio.frontend.detect_and_describe_multi = detect
    vio.set_tracing(traced)
    Timing.reset()
    s0 = syncstats.snapshot()
    ts_ns = (traj.ts * 1e9).astype(np.int64)
    imu_i = 0
    for fi in range(N_FRAMES):
        t_ns = int(fi * 0.1 * 1e9)
        while imu_i < len(ts_ns) and ts_ns[imu_i] <= t_ns + 25_000_000:
            vio.add_imu_measurement(int(ts_ns[imu_i]), traj.gyro[imu_i], traj.acc[imu_i])
            imu_i += 1
        vio.add_image(t_ns, 0, None)
        vio.add_image(t_ns, 1, None)
        vio.wait_idle(timeout=120)
    s1 = syncstats.snapshot()
    mgr = vio.posegraph
    out = dict(export=vio.export_trace(), syncs={k: s1.get(k, 0) - s0.get(k, 0) for k in s1},
               timing={k: a.count for k, a in Timing._timers.items()},
               trajectory=[(s.timestamp_ns, s.is_keyframe, s.T_WS.r.numpy().copy(), s.T_WS.q.numpy().copy())
                           for s in vio.trajectory],
               events=None if mgr is None else list(mgr.loop_events),
               graph=None if mgr is None else (mgr.graph.node_r.copy(), mgr.graph.node_q.copy()), mgr=mgr)
    vio.shutdown()
    return out


@pytest.fixture(scope="module")
def runs():
    return dict(traced=_run(True), untraced=_run(False), off=_run(False, posegraph=False))


def _children(f: dict, parent: dict) -> list:
    return [s for s in f["spans"] if s["parent"] == parent["id"]]


def _layer_spans(run: dict) -> list:
    """Each keyframe's `3.3 posegraph` span with its frame."""
    return [(f, s) for f in run["export"]["frames"] for s in f["spans"] if s["name"] == "3.3 posegraph"]


def test_every_keyframe_feeds_queries_and_inserts_once(runs):
    run = runs["traced"]
    stages = _layer_spans(run)
    keyframes = [t for t, kf, _, _ in run["trajectory"] if kf]
    assert [f["stamp"] for f, _ in stages] == keyframes and len(keyframes) >= 3
    for f, stage in stages:
        assert f["spans"][0]["attrs"]["keyframe"] is True
        names = Counter(s["name"] for s in _children(f, stage))
        assert names["posegraph.feed"] == names["posegraph.query"] == names["posegraph.insert"] == 1, names
        # an accepted loop reads the verified model once more, for its edge, before the solve
        assert names.pop("sync.posegraph_verify", 0) == names["posegraph.solve"] <= names["posegraph.verify"] <= 1
        assert set(names) <= set(LAYER)
        for s in _children(f, stage):
            assert stage["start_ns"] <= s["start_ns"] <= s["end_ns"] <= stage["end_ns"]
        order = [s["name"] for s in sorted(_children(f, stage), key=lambda s: s["start_ns"])]
        assert order[0] == "posegraph.feed" and order[1] == "posegraph.query" and order[-1] == "posegraph.insert"
    # the frames that are not keyframes enter no part of the layer
    for f in run["export"]["frames"]:
        if not f["spans"][0]["attrs"]["keyframe"]:
            assert not any(s["name"] in LAYER + ("3.3 posegraph",) for s in f["spans"])


def test_verify_and_solve_spans_are_the_loop_events(runs):
    run = runs["traced"]
    spans = [s for f in run["export"]["frames"] for s in sorted(f["spans"], key=lambda s: s["start_ns"])]
    verify = [s["attrs"] for s in spans if s["name"] == "posegraph.verify"]
    events = run["events"]
    assert len(verify) == len(events) >= 1
    assert [(a["num_inliers"], a["accepted"]) for a in verify] == [(e.num_inliers, e.accepted) for e in events]
    accepted = [e for e in events if e.accepted]
    solves = [s["attrs"] for s in spans if s["name"] == "posegraph.solve"]
    assert len(solves) == len(accepted) >= 1
    for a in solves:
        assert 2 <= a["nodes"] <= N_FRAMES and a["nodes"] <= a["edges"] <= 2 * a["nodes"]
    # a query passes its candidate on to verification exactly when its score reaches the threshold
    queries = [s["attrs"] for s in spans if s["name"] == "posegraph.query"]
    passed = [a for a in queries if a["passed"]]
    assert len(passed) == len(events)
    assert [a["score"] for a in passed] == [e.score for e in events]
    threshold = run["mgr"].cfg.score_threshold
    assert all((a["score"] >= threshold) == a["passed"] for a in queries if a["score"] > 0)


def test_feed_span_counts_the_landmarks_handed_over(runs):
    run = runs["traced"]
    mgr = run["mgr"]
    feeds = [s["attrs"]["valid_landmarks"] for f, stage in _layer_spans(run) for s in _children(f, stage)
             if s["name"] == "posegraph.feed"]
    held = [int(mgr.db.lm_valid[mgr.db.slot_of[kf]].sum()) for kf in mgr.insert_order]
    assert feeds == held and max(feeds) > 0


def test_timing_counts_are_the_span_counts(runs):
    run = runs["traced"]
    spans = Counter(s["name"] for f in run["export"]["frames"] for s in f["spans"])
    timed = run["timing"]
    for name in LAYER + ("3.3 posegraph",):
        assert timed.get(name, 0) == spans[name], name
    assert timed["posegraph.query"] == timed["posegraph.feed"] == timed["posegraph.insert"] == timed["3.3 posegraph"]
    assert timed["posegraph.verify"] == len(run["events"])
    assert timed["posegraph.solve"] == sum(e.accepted for e in run["events"])
    assert runs["untraced"]["timing"] == timed  # Timers count the same whether traced or not


def test_posegraph_syncs_per_query_verification_and_solve(runs):
    run = runs["traced"]
    inside = Counter()
    for f, stage in _layer_spans(run):
        for part in _children(f, stage):
            tags = Counter(s["name"] for s in _children(f, part) if s["name"].startswith("sync."))
            n = {t: sum(s["attrs"].get("n", 1) for s in _children(f, part) if s["name"] == t) for t in tags}
            if part["name"] == "posegraph.query":
                # an empty database, or one holding only excluded keyframes, is not read
                assert n in ({}, {"sync.posegraph_query": 2}), n
            elif part["name"] == "posegraph.verify":
                assert n == {"sync.posegraph_verify": 1}, n
            elif part["name"] == "posegraph.solve":
                assert n == {"sync.posegraph_solve": 1}, n
            inside.update(n)
    syncs, events = run["syncs"], run["events"]
    accepted = sum(e.accepted for e in events)
    assert inside["sync.posegraph_query"] == syncs["posegraph_query"] >= 2 * len(events)
    assert inside["sync.posegraph_verify"] == len(events)
    # an accepted loop reads its model once more for the edge, between the verification and the solve
    assert syncs["posegraph_verify"] == len(events) + accepted
    assert inside["sync.posegraph_solve"] == syncs["posegraph_solve"] == accepted
    assert runs["untraced"]["syncs"] == syncs


def test_tracing_changes_no_pose_loop_event_or_trajectory(runs):
    on, off = runs["traced"], runs["untraced"]
    assert off["export"] == {"frames": [], "threads": {}}
    assert on["events"] == off["events"]
    assert all(np.array_equal(a, b) for a, b in zip(on["graph"], off["graph"]))
    assert len(on["trajectory"]) == len(off["trajectory"]) == N_FRAMES
    for (t_a, kf_a, r_a, q_a), (t_b, kf_b, r_b, q_b) in zip(on["trajectory"], off["trajectory"]):
        assert (t_a, kf_a) == (t_b, kf_b) and np.array_equal(r_a, r_b) and np.array_equal(q_a, q_b)


def test_layer_off_records_no_posegraph_timing_row(runs):
    timed = runs["off"]["timing"]
    assert "frame" in timed and "3.1 optimization" in timed
    assert not any(k.startswith("posegraph.") or k == "3.3 posegraph" for k in timed), sorted(timed)
    assert not any(k.startswith("posegraph_") for k, v in runs["off"]["syncs"].items() if v)
    # the states are those of the run with the layer on: it reads the estimator and never writes it
    for a, b in zip(runs["off"]["trajectory"], runs["untraced"]["trajectory"]):
        assert a[:2] == b[:2] and np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
