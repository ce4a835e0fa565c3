"""The port's span tree (okvis_tpu_torch.utils.timing's Tracer, driven by
ThreadedVio.set_tracing), the blocking-fetch spans of utils.syncstats.sync,
the solver's useful-iteration rule, utils.profiling's attribution of
device operations and idle gaps to spans, and the benchmark's readers of
the Timing entries the program keeps. Imports no JAX.

The CPU tests run a few frames of ThreadedVio with a stub detector. The
`cuda` test runs frames of the benchmark's stereo spin on the card with
torch.cuda.set_sync_debug_mode("warn"): every synchronizing call must lie
inside a `sync.*` span, and 99 % of the profiled device operations must be
charged to a span. On an H100:

    python -m pytest tests/test_torch_tracing.py -q -m cuda --noconftest
"""

import threading
import time
import warnings
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from okvis_tpu_torch import convert
from okvis_tpu_torch.cameras.ncamera import NCameraSystem
from okvis_tpu_torch.config import VioParameters
from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, keypoint_frames, make_landmarks, simulate_trajectory
from okvis_tpu_torch.pipeline import ThreadedVio
from okvis_tpu_torch.solver.optimize import useful_iterations
from okvis_tpu_torch.utils import profiling, syncstats, timing
from okvis_tpu_torch.utils.ids import IdProvider
from okvis_tpu_torch.utils.timing import Timer, Timing, Tracer

torch.set_num_threads(2)
N_FRAMES, K = 6, 64
STAGES = ("1.x detectAndDescribe", "2.1 addStates", "2.4 matching", "3.1 optimization", "3.2 marginalization")


def _stub_pipeline(traced: bool) -> dict:
    """N_FRAMES keypoint frames through a float64 CPU ThreadedVio behind a
    stub detector (test_torch_cuda.py's _stub_runtime world): its export,
    the syncstats deltas, the Timing stage names and counts, the frames'
    ids and the configured iterations."""
    traj = simulate_trajectory(duration=1.2, seed=31, motion_scale=0.25)
    lms = make_landmarks(traj, 600, seed=32, radius=(4.0, 8.0))
    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    rig = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)
    rig.compute_overlaps()
    frames = iter(keypoint_frames(traj, lms, rig, N_FRAMES, K, seed=3))
    params = VioParameters()
    params.optimization.max_num_keypoints = K
    IdProvider.reset()
    vio = ThreadedVio(params, rig=rig, blocking=True, dtype=torch.float64, device="cpu")

    def detect(images, T_WS=None):
        f = next(frames)
        return [convert.frame_from_numpy(f.uv[c], np.ones(K), f.mask[c], f.descriptors[c], np.zeros(K, np.int64),
                                         device="cpu", dtype=torch.float32) for c in range(len(images))]

    vio.frontend.detect_and_describe_multi = detect
    if traced:
        vio.set_tracing(True)
    Timing.reset()
    s0 = syncstats.snapshot()
    ts_ns = (traj.ts * 1e9).astype(np.int64)
    imu_i, stamps = 0, []
    for fi in range(N_FRAMES):
        t_ns = int(fi * 0.1 * 1e9)
        while imu_i < len(ts_ns) and ts_ns[imu_i] <= t_ns + 25_000_000:
            vio.add_imu_measurement(int(ts_ns[imu_i]), traj.gyro[imu_i], traj.acc[imu_i])
            imu_i += 1
        vio.add_image(t_ns, 0, None)
        vio.add_image(t_ns, 1, None)
        vio.wait_idle(timeout=120)
        stamps.append(t_ns)
    s1 = syncstats.snapshot()
    out = dict(export=vio.export_trace(), syncs={k: s1.get(k, 0) - s0.get(k, 0) for k in s1},
               timing={k: a.count for k, a in Timing._timers.items()}, stamps=stamps,
               iterations=vio.estimator.cfg.max_iterations, tracer=vio._tracer,
               trajectory=[(s.timestamp_ns, s.T_WS.r.numpy().copy()) for s in vio.trajectory])
    vio.shutdown()
    return out


@pytest.fixture(scope="module")
def runs():
    return {traced: _stub_pipeline(traced) for traced in (True, False)}


# ---------------------------------------------------------------- the pipeline's span tree
def test_one_frame_span_per_processed_frame_with_its_id(runs):
    frames = runs[True]["export"]["frames"]
    assert [f["stamp"] for f in frames] == runs[True]["stamps"]
    for f in frames:
        head = f["spans"][0]
        assert head["name"] == "frame" and head["parent"] is None and head["thread"] is None
        assert head["attrs"]["id"] > 0 and isinstance(head["attrs"]["keyframe"], bool)
        assert sum(s["name"] == "frame" for s in f["spans"]) == 1
        names = Counter(s["name"] for s in f["spans"])
        for stage in STAGES + ("wait.imu", "wait.keypoints", "optimize.enqueue", "host: build problem",
                               "host: optimize update", "sync.optimize_fetch"):
            assert names[stage] == 1, (f["stamp"], stage)
    assert len({f["spans"][0]["attrs"]["id"] for f in frames}) == N_FRAMES
    # the frames after the first preintegrate their links; those that
    # marginalize check three eigendecompositions inside `marginalize`
    assert all(any(s["name"] == "preintegrate" for s in f["spans"]) for f in frames[1:])
    assert any(sum(s["name"] == "sync.marg_eigh" for s in f["spans"]) == 3 for f in frames)


def test_every_span_nests_in_its_parent_and_its_frame(runs):
    for f in runs[True]["export"]["frames"]:
        by_id = {s["id"]: s for s in f["spans"]}
        head = f["spans"][0]
        for s in f["spans"][1:]:
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"], (s["name"], parent["name"])
            assert head["start_ns"] <= s["start_ns"] and s["end_ns"] <= head["end_ns"]
            if parent["thread"] is not None:
                assert s["thread"] == parent["thread"]
        chain = {s["name"]: by_id[s["parent"]]["name"] for s in f["spans"][1:]}
        assert chain["optimize.enqueue"] == chain["host: build problem"] == "3.1 optimization"
        assert chain["3.1 optimization"] == chain["wait.keypoints"] == chain["wait.imu"] == "frame"
        if "preintegrate" in chain:
            assert {by_id[s["parent"]]["name"] for s in f["spans"] if s["name"] == "preintegrate"} <= {
                "host: build problem", "3.2 marginalization"}
        if "sync.marg_eigh" in chain:
            assert chain["sync.marg_eigh"] == "marginalize" and chain["marginalize"] == "3.2 marginalization"


def test_sync_spans_count_what_syncstats_counts(runs):
    spans = Counter()
    for f in runs[True]["export"]["frames"]:
        for s in f["spans"]:
            if s["name"].startswith("sync."):
                spans[s["name"][5:]] += s["attrs"].get("n", 1)
    assert dict(spans) == {k: v for k, v in runs[True]["syncs"].items() if v}
    assert spans["marg_eigh"] > 0 and spans["upload"] > 0


def test_optimize_span_carries_the_solver_iterations(runs):
    for f in runs[True]["export"]["frames"]:
        (opt,) = [s for s in f["spans"] if s["name"] == "3.1 optimization"]
        a = opt["attrs"]
        assert a["iterations"] == runs[True]["iterations"]
        assert 0 <= a["accepted"] <= a["iterations"] and 0 <= a["useful"] <= a["iterations"]
        assert a["useful"] >= 1  # every frame's first iteration lowers the cost


def test_tracing_changes_no_result_fetch_or_timing_entry(runs):
    on, off = runs[True], runs[False]
    assert off["export"] == {"frames": [], "threads": {}}
    assert not off["tracer"]._spans and not off["tracer"]._frames
    assert on["syncs"] == off["syncs"]  # the iteration counts ride the existing fetch
    assert on["timing"] == off["timing"]  # spans add no Timing entry; Timers count the same either way
    assert set(on["timing"]) >= set(STAGES) and not any(k.endswith(" detect") for k in on["timing"])
    for (t_a, r_a), (t_b, r_b) in zip(on["trajectory"], off["trajectory"]):
        assert t_a == t_b and np.array_equal(r_a, r_b)


def test_timing_counts_what_the_spans_record(runs):
    """The registry's `frame`, `preintegrate` and `sync.<tag>` entries,
    which the benchmark reads, count the spans of the same names, and a
    frame's stages never overlap (pipeline.wait_ms takes their sum for
    their union)."""
    spans = Counter(s["name"] for f in runs[True]["export"]["frames"] for s in f["spans"])
    timed = runs[True]["timing"]
    assert timed["frame"] == spans["frame"] == N_FRAMES
    assert timed["preintegrate"] == spans["preintegrate"] > 0
    tags = {k for k in spans if k.startswith("sync.")}
    assert tags and {k: timed[k] for k in tags} == {k: spans[k] for k in tags}
    assert tags == {k for k in timed if k.startswith("sync.")}
    for f in runs[True]["export"]["frames"]:
        stages = sorted((s["start_ns"], s["end_ns"]) for s in f["spans"] if s["name"] in STAGES)
        assert all(e0 <= s1 for (_, e0), (s1, _) in zip(stages, stages[1:]))
        assert not any(s["name"].startswith("sync.") and s["parent"] in
                       {p["id"] for p in f["spans"] if p["name"].startswith("sync.")} for s in f["spans"])


# ---------------------------------------------------------------- Tracer units
def test_two_tracers_never_mix_and_export_forgets():
    a, b = Tracer(), Tracer()
    a.enabled = b.enabled = True
    seen = {}

    def work(tr, stamp, name):
        tr.image_added(stamp)
        with tr.frame(stamp, start=True):
            with Timer(name):
                with syncstats.sync("unit_test_tag"):
                    pass
                timing.annotate(name, k=1)
            timing.begin("handed")
        with tr.frame(stamp):
            timing.end("handed")
        tr.close_frame(stamp, id=stamp)
        seen[name] = threading.get_native_id()

    threads = [threading.Thread(target=work, args=(a, 5, "x")), threading.Thread(target=work, args=(b, 7, "y"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    ea, eb = a.export(), b.export()
    assert [[s["name"] for s in f["spans"]] for f in ea["frames"]] == [["frame", "sync.unit_test_tag", "x", "handed"]]
    assert [f["stamp"] for f in eb["frames"]] == [7] and eb["frames"][0]["spans"][2]["name"] == "y"
    assert ea["frames"][0]["spans"][2]["attrs"] == {"k": 1}
    assert ea["frames"][0]["spans"][2]["thread"] == seen["x"] and seen["x"] in ea["threads"]
    assert a.export()["frames"] == [] and not timing.tracing()
    for name in ("x", "y", "sync.unit_test_tag", "frame"):
        Timing._timers.pop(name, None)


def test_disabled_tracer_and_untraced_thread_record_nothing():
    Timing._timers.pop("frame", None)
    tr = Tracer()
    tr.image_added(1)  # an image that never made a frame is forgotten by the next frame
    tr.image_added(3)
    with tr.frame(3, start=True) as f:
        assert f is None and not timing.tracing()
        with Timer("unit_test_timer"), timing.span("s"), syncstats.sync("unit_test_tag"):
            pass
    tr.close_frame(3)
    assert tr.export() == {"frames": [], "threads": {}} and not tr._spans
    assert not tr._images and not tr._starts and not tr._frames
    # the registry keeps its totals with tracing off: the Timers, the sync's and the frame's
    assert Timing._timers.pop("unit_test_timer").count == 1
    assert Timing._timers.pop("sync.unit_test_tag").count == 1
    assert Timing._timers.pop("frame").count == 1 and "s" not in Timing._timers


# ---------------------------------------------------------------- the useful-iteration rule
@pytest.mark.parametrize("hist,accepted,cost0,want", [
    ([50.0, 50.0, 49.99999, 49.0], [True, False, True, True], 100.0, 4),  # 2e-7 relative is not useful, 2% is
    ([50.0, 49.99999, 49.999985], [True, True, True], 100.0, 1),
    ([100.0, 100.0], [False, False], 100.0, 0),
    ([99.99995, 99.0], [True, True], 100.0, 2),  # 5e-7 at the first, 1% at the second
    ([99.99995, 99.99990], [True, True], 100.0, 0),
    ([10.0, 10.0, 9.0], [True, False, True], None, 3),  # no initial cost: an accepted first step counts
    ([10.0, 10.0], [False, False], None, 0),
])
def test_useful_iterations(hist, accepted, cost0, want):
    assert useful_iterations(np.asarray(hist), np.asarray(accepted), cost0) == want


# ---------------------------------------------------------------- attribution
def _cpu_ops_and_spans(prof):
    """The aten operations of a CPU profiler run as `device` operations
    launched where they ran, and its record_function ranges as spans."""
    ops, spans, names = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("aten::"):
            ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_ns(), e.start_thread_id()))
        elif e.name().startswith("span_"):
            spans.append((len(spans) + 1, e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()))
            names[len(spans)] = e.name()
    return sorted(ops, key=lambda o: o[1]), spans, names


def test_attribute_charges_operations_to_their_span_and_gaps_to_the_midpoint():
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(64)
    done = threading.Event()

    def other_thread():  # operations on a thread with no span open
        for _ in range(5):
            x * 3.0
        done.set()

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        with record_function("span_outer"):
            x + 1.0
            with record_function("span_inner"):
                x * 2.0
                x.sum()
            t = threading.Thread(target=other_thread)
            t.start()
            done.wait(10)
            t.join(10)
            x + 2.0
            time.sleep(0.05)  # a long gap inside span_outer
            x + 3.0
        x + 4.0
        time.sleep(0.05)  # and one outside every span
        with record_function("span_last"):
            x - 1.0
    ops, spans, names = _cpu_ops_and_spans(prof)
    t0, t1 = min(s for _, s, *_ in spans), max(e for _, _, e, _ in spans)
    res = profiling.attribute(ops, spans, t0, t1)
    # each operation, charged by hand: the innermost span on its own thread
    want = Counter()
    for _, s, _, launch, th in ops:
        open_ = [(st, sid) for sid, st, en, sth in spans if sth == th and st <= launch < en]
        want[max(open_)[1] if open_ else None] += 1
    assert {sid: n for sid, n in want.items() if sid is not None} == res["launches"]
    assert res["not_charged"] == {"outside the program's spans": want[None]} and want[None] >= 5
    by_name = {names[sid]: n for sid, n in res["launches"].items()}
    assert by_name["span_inner"] >= 2 and by_name["span_outer"] >= 1 and by_name["span_last"] >= 1
    idle = {names.get(sid): ns for sid, ns in res["idle_ns"].items()}
    assert idle["span_outer"] >= 0.05e9 and idle[None] >= 0.05e9
    assert res["operations"] == len(ops) and 0 < res["busy_ns"] < res["window_ns"]


class _Event(SimpleNamespace):
    def name(self): return self.n  # noqa: E704
    def device_type(self): return self.dt  # noqa: E704
    def start_ns(self): return self.s  # noqa: E704
    def duration_ns(self): return self.d  # noqa: E704
    def correlation_id(self): return self.c  # noqa: E704
    def device_resource_id(self): return self.r  # noqa: E704
    def is_user_annotation(self): return self.a  # noqa: E704


def _fake_prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


def test_device_operations_join_their_launch_and_busy_is_a_union():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ev = [_Event(n="k1", dt=cuda, s=100, d=50, c=7, r=0, a=False),
          _Event(n="k2", dt=cuda, s=120, d=50, c=8, r=0, a=False),  # overlaps k1
          _Event(n="k3", dt=cuda, s=400, d=10, c=9, r=0, a=False),  # no launch call in the trace
          _Event(n="span", dt=cuda, s=90, d=400, c=1, r=0, a=True),  # a GPU-side annotation, no operation
          _Event(n="cudaLaunchKernel", dt=cpu, s=60, d=5, c=7, r=11, a=False),
          _Event(n="cudaMemcpyAsync", dt=cpu, s=70, d=5, c=8, r=12, a=False),
          _Event(n="aten::add", dt=cpu, s=50, d=30, c=9, r=11, a=False)]  # a torch op's own id, not CUPTI's
    ops = profiling.device_operations(_fake_prof(ev))
    assert ops == [("k1", 100, 150, 60, 11), ("k2", 120, 170, 70, 12), ("k3", 400, 410, None, None)]
    summary = profiling.profile_summary(_fake_prof(ev), frames=1, wall_ms=1e-3)
    assert summary["busy_ms"] == pytest.approx(80e-6) and summary["kernel_ms"] > summary["busy_ms"]
    assert summary["device_busy_share"] == pytest.approx(0.08)
    # 12 is the pthread alias of the spans' thread 5; 11 is no span's
    # thread, so only the span open on every thread can take its launch
    res = profiling.attribute(ops, [(1, 0, 1000, None), (2, 50, 80, 5), (3, 65, 90, 5)], 0, 1000, {5: 12})
    assert res["launches"] == {1: 1, 3: 1} and res["not_charged"] == {"no launch call in the trace": 1}
    assert res["busy_ns"] == 80 and sum(res["idle_ns"].values()) == 920


def test_attribute_to_frames_charges_within_each_stage():
    export = {"frames": [{"stamp": 0, "spans": [
        dict(name="frame", id=1, parent=None, start_ns=0, end_ns=1000, thread=None, attrs={}),
        dict(name="3.1 optimization", id=2, parent=1, start_ns=100, end_ns=600, thread=5, attrs={}),
        dict(name="optimize.enqueue", id=3, parent=2, start_ns=150, end_ns=300, thread=5, attrs={}),
        dict(name="sync.optimize_fetch", id=4, parent=2, start_ns=300, end_ns=590, thread=5, attrs={})]}],
        "threads": {5: 99}}
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ev = []
    for i, (launch, thread) in enumerate([(160, 99), (170, 5), (120, 5), (700, 5), (50, 42)]):
        ev += [_Event(n=f"k{i}", dt=cuda, s=launch + 5, d=3, c=100 + i, r=0, a=False),
               _Event(n="cudaLaunchKernel", dt=cpu, s=launch, d=2, c=100 + i, r=thread, a=False)]
    out = profiling.attribute_to_frames(_fake_prof(ev), export)
    assert out["launches_by_span"] == {"optimize.enqueue": 2, "3.1 optimization": 1, "frame": 2}
    assert out["launches_within"] == {"optimize.enqueue": 2, "3.1 optimization": 3, "frame": 5}
    assert out["operations"] == 5 and out["not_charged"] == {}
    gaps = dict(out["idle_gaps_by_span"])
    assert gaps["sync.optimize_fetch"] == pytest.approx(527e-9) and sum(gaps.values()) == pytest.approx(985e-9)


# ---------------------------------------------------------------- the benchmark's readers
def _record(stages_n=None, kernels=None, **extra):
    """A traced run's record: 3 frames of 100 ms whose stages took 8 ms of
    detection, 18 of matching, 90 of optimization, 60 of marginalization;
    each Timing row's count (`stages_n`) 3 unless given, and the timed
    kernel shapes where given."""
    stages = {"1.x detectAndDescribe": 0.024, "2.1 addStates": 0.0, "2.4 matching": 0.018, "3.1 optimization": 0.09,
              "3.2 marginalization": 0.06, "host: build problem": 0.03, **extra}
    record = {"frames": 3, "stages_s": stages, "stages_n": {**{k: 3 for k in stages}, **(stages_n or {})},
              "syncs": {"optimize_fetch": 3}}
    if kernels is not None:
        record["kernels"] = kernels
    return record


# a window of 4 keyframes: 4 queries, 2 verifications, 1 loop closed
POSEGRAPH_N = {"3.3 posegraph": 4, "posegraph.query": 4, "posegraph.verify": 2, "posegraph.solve": 1}
POSEGRAPH_S = {"3.3 posegraph": 0.26, "posegraph.query": 0.02, "posegraph.verify": 0.009, "posegraph.solve": 0.03}
# the database Hamming at one shape, 3 launches of 68 us against a 51 us bound
HAMMING_DB = {"hamming_db": [dict(shape=[1, 400, 102400], count=3, time_s=68e-6, bound_s=51e-6)],
              "hamming": [dict(shape=[1, 400, 400], count=9, time_s=4e-6, bound_s=1e-6)]}


WANT = {
    # the frames' 300 ms less the stages' 192 ms (host: build problem lies inside 3.1 optimization)
    "pipeline.wait_ms": (dict(frame=0.3), 36.0),
    "pipeline.sync_wait_ms": ({"sync.optimize_fetch": 0.0045, "sync.upload": 0.0015}, 2.0),
    "estimator.preintegrate_ms": (dict(preintegrate=0.0096), 3.2),
    "posegraph.keyframe_ms": (dict(POSEGRAPH_S, stages_n=POSEGRAPH_N), 65.0),
    "posegraph.query_ms": (dict(POSEGRAPH_S, stages_n=POSEGRAPH_N), 5.0),
    "posegraph.verify_ms": (dict(POSEGRAPH_S, stages_n=POSEGRAPH_N), 4.5),
    "posegraph.solve_ms": (dict(POSEGRAPH_S, stages_n=POSEGRAPH_N), 30.0),
    "posegraph.loops_per_keyframe": (dict(POSEGRAPH_S, stages_n=POSEGRAPH_N), 0.25),
    "posegraph.hamming_db_roofline": (dict(kernels=HAMMING_DB), 75.0),  # the frontend's `hamming` rows not counted
}


@pytest.mark.parametrize("case", ["program", "parent", "empty"])
@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_hand_built_record(name, case):
    from vio_bench import harness

    read = harness.metric_reader(name)
    entries, want = WANT[name]
    if case == "program":
        assert read(_record(**entries)) == pytest.approx(want)
    elif case == "parent":  # a commit whose program keeps no such Timing entry
        assert read(_record()) is None
    else:
        assert read({}) is None and read(None) is None and read({"frames": 0, "stages_s": entries}) is None


def test_loops_reader_tells_no_loop_from_no_counter():
    """A window that closed no loop reads 0; a commit whose program kept
    `3.3 posegraph` but not the layer's own Timers reads nothing."""
    from vio_bench import harness

    read = harness.metric_reader("posegraph.loops_per_keyframe")
    no_loop = {k: v for k, v in POSEGRAPH_N.items() if k != "posegraph.solve"}
    assert read(_record(stages_n=no_loop, **{k: POSEGRAPH_S[k] for k in no_loop})) == 0
    assert read(_record(stages_n={"3.3 posegraph": 4}, **{"3.3 posegraph": 0.26})) is None


# ---------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_traced_frames_on_the_card_wait_only_in_sync_spans(card):
    """Frames of the benchmark's stereo spin (keyframes, marginalization)
    under set_sync_debug_mode("warn"): every synchronizing call a pipeline
    thread makes lies inside a `sync.*` span of its thread, marginalize's
    eigh checks among them; then two profiled frames, 99 % of whose device
    operations are charged to a program span."""
    from torch.profiler import ProfilerActivity, profile

    from vio_bench import harness, world

    config = harness.load_json(harness.config_file("euroc_stereo"))
    stream = world.make_stream(config, harness.load_json(harness.traffic_file("spin")), 2**31 + 5, card)
    vio = ThreadedVio(harness.vio_parameters(config), blocking=True, dtype=torch.float32, device=card)
    try:
        imu_i = 0
        for n in range(4):
            imu_i, _ = harness.feed(vio, stream, n, imu_i)
        vio.set_tracing(True)
        hits = []

        def show(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing CUDA operation" in str(message):
                hits.append((time.time_ns(), threading.get_native_id(), filename, lineno))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for n in range(4, 14):
                    imu_i, _ = harness.feed(vio, stream, n, imu_i)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        export = vio.export_trace()
        assert len(export["frames"]) == 10
        syncs = [s for f in export["frames"] for s in f["spans"] if s["name"].startswith("sync.")]
        workers = {t.native_id for t in vio._threads}
        outside = Counter()
        for t, tid, filename, lineno in hits:
            assert tid in workers, (filename, lineno)
            if not any(s["thread"] == tid and s["start_ns"] <= t <= s["end_ns"] for s in syncs):
                outside[f"{filename}:{lineno}"] += 1
        assert hits
        if outside:
            pytest.fail("synchronizing calls outside a sync span:\n" + "\n".join(
                f"{site} x{n}" for site, n in sorted(outside.items(), key=lambda kv: -kv[1])))
        eigh = [s for s in syncs if s["name"] == "sync.marg_eigh"]
        assert eigh and all(any(s["start_ns"] <= t <= s["end_ns"] for t, *_ in hits) for s in eigh)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for n in range(14, 16):
                imu_i, _ = harness.feed(vio, stream, n, imu_i)
            torch.cuda.synchronize()
        att = profiling.attribute_to_frames(prof, vio.export_trace())
        charged = att["operations"] - sum(att["not_charged"].values())
        assert att["operations"] > 10_000 and charged >= 0.99 * att["operations"], att["not_charged"]
        for stage in ("1.x detectAndDescribe", "2.4 matching", "3.1 optimization", "3.2 marginalization"):
            assert att["launches_within"].get(stage, 0) > 0, stage
    finally:
        vio.shutdown()
