"""One run of one cell: set up okvis_tpu_torch's ThreadedVio on the cell's
rig and stream, warm it up, time a window of frames, read the traced
metrics, and hold what the window produced to the plain reference.

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration `configs/<config>.json`, its traffic `traffic/<traffic>.json`,
its limits `limits/<cell>.json`, and each per-layer metric's reader
`metrics/<metric>.py`.

What is timed is the entry a user's program calls, as upstream's
okvis_app_synchronous runs EuRoC: for each frame the IMU samples up to 25
ms past it (`add_imu_measurement`), each camera's image (`add_image`), and
`wait_idle`; blocking mode, one frame in flight, full iterations. The
benchmark's taps on the program (below) keep references to a sample of its
outputs and, in a traced run, count kernel shapes: they add no device work
and no synchronisation to a frame.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import random
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import check, kernels, trace, world

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
IMU_LEAD_NS = 25_000_000  # IMU fed past a frame's stamp before its images (the frame waits for +20 ms)
STRETCH_FRAMES = 3  # profiled frames after the window of a traced run
SAMPLES = 6  # frames, Hamming calls, retrievals and solves of the window kept for the reference
# the pose graph's host arrays a solve reads (okvis_tpu_torch.posegraph.graph.PoseGraph)
GRAPH_ARRAYS = ("node_r", "node_q", "node_mask", "fixed", "edge_i", "edge_j", "meas_r", "meas_q", "sqrt_info",
                "edge_mask")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def limits_file(cell: str) -> Path:
    return HERE / "limits" / f"{cell}.json"


def metric_reader(name: str) -> Callable:
    """`read(record)` of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vio_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(cell: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries that apply to `cell`."""
    return [m for m in benchmark()[kind] if cell in m.get("workloads", [cell])]


def vio_parameters(config: dict):
    """okvis_tpu_torch's VioParameters for a configuration file."""
    from okvis_tpu_torch.config.parameters import CameraConfig, ImuConfig, VioParameters

    p = VioParameters()
    p.cameras = [CameraConfig(T_SC=np.asarray(c["T_SC"], float).reshape(4, 4),
                              image_dimension=tuple(c["image_dimension"]),
                              distortion_coefficients=list(c["distortion_coefficients"]),
                              distortion_type=c["distortion_type"], focal_length=tuple(c["focal_length"]),
                              principal_point=tuple(c["principal_point"])) for c in config["cameras"]]
    for k, v in config["camera_params"].items():
        setattr(p.camera_params, k, v)
    p.camera_params.camera_rate = float(config["camera_rate_hz"])
    imu = dict(config["imu"])
    imu["a0"] = tuple(imu["a0"])
    p.imu = ImuConfig(**imu)
    o = p.optimization
    o.num_keyframes, o.num_imu_frames = config["numKeyframes"], config["numImuFrames"]
    ceres = config["ceres_options"]
    o.min_iterations, o.max_iterations, o.time_limit = ceres["minIterations"], ceres["maxIterations"], ceres["timeLimit"]
    det = config["detection_options"]
    o.detection_threshold, o.detection_octaves, o.max_num_keypoints = (
        det["threshold"], det["octaves"], det["maxNoKeypoints"])
    p.posegraph = posegraph_parameters(config["posegraph"])
    return p


def posegraph_parameters(value):
    """okvis_tpu_torch's PoseGraphConfigParams for a configuration's
    "posegraph": false (the layer off), or an object of the dataclass's
    fields (an unknown key is an error)."""
    from okvis_tpu_torch.config.parameters import PoseGraphConfigParams

    if isinstance(value, bool):
        return PoseGraphConfigParams(enabled=value)
    fields = {f.name for f in dataclasses.fields(PoseGraphConfigParams)}
    unknown = sorted(set(value) - fields)
    if unknown:
        raise ValueError(f"unknown pose-graph settings {unknown}; known: {sorted(fields)}")
    return PoseGraphConfigParams(**value)


class Reservoir:
    """A uniform sample of at most `k` items of a stream, from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self._rng = random.Random(seed)

    def admit(self) -> Optional[int]:
        """Counts one item of the stream: the place its copy goes to, or
        None where the sample does not keep it (nothing need be copied)."""
        self.n += 1
        if self.n <= self.k:
            return self.n - 1
        j = self._rng.randrange(self.n)
        return j if j < self.k else None

    def put(self, j: int, item) -> None:
        if j == len(self.items):
            self.items.append(item)
        else:
            self.items[j] = item

    def offer(self, item) -> None:
        j = self.admit()
        if j is not None:
            self.put(j, item)


class Taps:
    """The benchmark's side of the program's layer boundaries: wrappers that
    keep references to a sample of the window's detections and Hamming
    matrices, count the hand kernels' launch shapes in a traced run, and
    record host spans around each layer's call while the stretch is
    profiled. Where the pipeline runs the pose-graph layer, they also keep
    host copies of a sample of its retrievals and solves, and count the
    database Hamming's launch shapes. Module-level wrappers, and the
    pose-graph layer's, are put back by `close`."""

    def __init__(self, vio, seed: int, count_shapes: bool):
        from okvis_tpu_torch.frontend import detection, kernels as fkernels

        self.active, self.spans_on = False, False
        self.detections = Reservoir(SAMPLES, seed)
        self.hamming = Reservoir(SAMPLES, seed + 1)
        self.shapes = {"harris_nms": Counter(), "hamming": Counter()}
        self.spans = []
        self._restore = []
        frontend, est = vio.frontend, vio.estimator

        detect = frontend.detect_and_describe_multi

        def detect_and_describe_multi(images, T_WS=None):
            out = detect(images, T_WS)
            if self.active:
                self.detections.offer((images, T_WS, out))
            return out

        frontend.detect_and_describe_multi = self._span("detect", detect_and_describe_multi)
        for obj, name, label in ((est, "add_states", "addStates"),
                                 (frontend, "data_association_and_initialization", "matching"),
                                 (est, "optimize", "optimize"),
                                 (est, "apply_marginalization_strategy", "marginalize")):
            setattr(obj, name, self._span(label, getattr(obj, name)))

        mdm = fkernels.masked_distance_matrix

        def masked_distance_matrix(desc_a, desc_b, mask_a=None, mask_b=None):
            out = mdm(desc_a, desc_b, mask_a, mask_b)
            if self.active:
                self.hamming.offer((desc_a, desc_b, mask_a, mask_b, out))
                if count_shapes:
                    self.shapes["hamming"][tuple(None if t is None else tuple(t.shape)
                                                 for t in (desc_a, desc_b, mask_a, mask_b))] += 1
            return out

        fkernels.masked_distance_matrix = masked_distance_matrix
        self._restore.append((fkernels, "masked_distance_matrix", mdm))
        if count_shapes:
            hs = detection.harris_suppressed

            def harris_suppressed(img, inb, *a, **k):
                if self.active:
                    self.shapes["harris_nms"][tuple(img.shape)] += 1
                return hs(img, inb, *a, **k)

            detection.harris_suppressed = harris_suppressed
            self._restore.append((detection, "harris_suppressed", hs))
        if vio.posegraph is not None:
            self._posegraph_taps(vio.posegraph, seed, count_shapes)

    def _posegraph_taps(self, manager, seed: int, count_shapes: bool) -> None:
        """Wrap the keyframe database's `query` and the graph's `optimize`:
        for the items the reservoirs keep, host copies of what the
        reference needs (the database's occupied slots, the graph's arrays
        before the solve and the poses after it); the database Hamming's
        launch shapes in a traced run. Host reads of host arrays only."""
        from okvis_tpu_torch.posegraph import place_recognition

        db, graph = manager.db, manager.graph
        self.retrieval = Reservoir(SAMPLES, seed + 2)
        self.solves = Reservoir(SAMPLES, seed + 3)
        query, optimize = db.query, graph.optimize

        def tapped_query(desc_q, mask_q, exclude_ids, vote_threshold=60):
            out = query(desc_q, mask_q, exclude_ids, vote_threshold)
            kf_id, _, scores = out
            j = self.retrieval.admit() if self.active and kf_id is not None else None  # None: nothing scored
            if j is not None:
                slots = np.nonzero(db.occupied)[0]
                allowed = db.occupied.copy()
                allowed[[db.slot_of[i] for i in exclude_ids if i in db.slot_of]] = False
                self.retrieval.put(j, dict(
                    desc_q=np.array(desc_q[:db.kp_cap]), mask_q=np.array(mask_q[:db.kp_cap], bool),
                    vote_threshold=vote_threshold, slots=slots, db_desc=db.desc[slots], db_mask=db.mask[slots],
                    allowed=allowed, scores=np.array(scores), best=db.slot_of[kf_id]))
            return out

        def tapped_optimize(*a, **k):
            j = self.solves.admit() if self.active else None
            before = None if j is None else {name: getattr(graph, name).copy() for name in GRAPH_ARRAYS}
            out = optimize(*a, **k)
            if j is not None:
                self.solves.put(j, dict(before=before, kwargs=dict(k), node_r=graph.node_r.copy(),
                                        node_q=graph.node_q.copy()))
            return out

        for obj, name, fn in ((db, "query", tapped_query), (graph, "optimize", tapped_optimize)):
            self._restore.append((obj, name, getattr(obj, name)))
            setattr(obj, name, fn)
        if count_shapes:
            self.shapes["hamming_db"] = Counter()
            mdm = place_recognition.masked_distance_matrix

            def masked_distance_matrix(desc_a, desc_b, mask_a=None, mask_b=None):
                if self.active:
                    self.shapes["hamming_db"][tuple(None if t is None else tuple(t.shape)
                                                    for t in (desc_a, desc_b, mask_a, mask_b))] += 1
                return mdm(desc_a, desc_b, mask_a, mask_b)

            place_recognition.masked_distance_matrix = masked_distance_matrix
            self._restore.append((place_recognition, "masked_distance_matrix", mdm))

    def _span(self, name: str, fn: Callable) -> Callable:
        def wrapped(*a, **k):
            if not self.spans_on:
                return fn(*a, **k)
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **k)
            finally:
                self.spans.append((name, t0, time.perf_counter_ns()))
        return wrapped

    def close(self) -> None:
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)
        self._restore = []


def feed(vio, stream: world.Stream, n: int, imu_i: int) -> tuple:
    """Frame n into `vio`: the IMU up to 25 ms past it, each camera's image,
    wait_idle. Returns (the next IMU index, host seconds from the first
    add_image to wait_idle's return)."""
    t_ns = stream.frame_ns(n)
    while stream.imu_ns(imu_i) <= t_ns + IMU_LEAD_NS:
        g, a = stream.imu_sample(imu_i)
        vio.add_imu_measurement(stream.imu_ns(imu_i), g, a)
        imu_i += 1
    t0 = time.perf_counter()
    for c, img in enumerate(stream.frame_images(n)):
        vio.add_image(t_ns, c, img)
    vio.wait_idle(timeout=300.0)
    return imu_i, time.perf_counter() - t0


def device_seconds(fn: Callable, reps: int = 21, inner: int = 10) -> float:
    """Median over `reps` of the device time of `inner` back-to-back calls,
    over `inner` (chip_smoke.py's device_ms): a sleep kernel queued first
    keeps the card busy while the host enqueues, so host overhead does not
    show."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / inner)
    return float(np.median(times))


def time_kernel_shapes(shapes: dict, stream: world.Stream, device) -> dict:
    """Each hand-kernel shape the window launched, timed alone with CUDA
    events: {kernel: [{shape, count, time_s, bound_s}]}. Harris runs on the
    stream's images; Hamming on random descriptors with every row valid,
    the frontend's matrices under `hamming` and the pose graph's database
    matrix under `hamming_db`."""
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda
    from okvis_tpu_torch.ops.hamming import masked_distance_matrix

    out = {kernel: [] for kernel in shapes}
    for (c, h, w), count in sorted(shapes["harris_nms"].items()):
        img = torch.as_tensor(stream.images[0][:c], dtype=torch.float32, device=device).contiguous()
        ys, xs = torch.arange(h, device=device)[:, None], torch.arange(w, device=device)[None, :]
        inb = ((ys >= 20) & (ys < h - 20) & (xs >= 20) & (xs < w - 20)).to(torch.float32).expand(c, h, w).contiguous()
        t = device_seconds(lambda: harris_suppressed_cuda(img, inb))
        out["harris_nms"].append(dict(shape=[c, h, w], count=count, time_s=t, bound_s=kernels.harris_bound_s(c, h, w)))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    for kernel, key, count in [(kernel, key, count) for kernel in ("hamming", "hamming_db")
                               for key, count in sorted(shapes.get(kernel, {}).items(), key=str)]:
        sa, sb, ma, mb = key
        a = torch.randint(-2**31, 2**31 - 1, sa, generator=gen, dtype=torch.int32, device=device)
        b = torch.randint(-2**31, 2**31 - 1, sb, generator=gen, dtype=torch.int32, device=device)
        m_a = None if ma is None else torch.ones(ma, dtype=torch.bool, device=device)
        m_b = None if mb is None else torch.ones(mb, dtype=torch.bool, device=device)
        res = masked_distance_matrix(a, b, m_a, m_b)
        g, na, nb = (res.shape if res.dim() == 3 else (1, *res.shape))
        in_bytes = sum(x.numel() * x.element_size() for x in (a, b, m_a, m_b) if x is not None)
        t = device_seconds(lambda: masked_distance_matrix(a, b, m_a, m_b))
        out[kernel].append(dict(shape=[g, na, nb], count=count, time_s=t,
                                bound_s=kernels.hamming_bound_s(g, na, nb, in_bytes)))
    return out


@dataclasses.dataclass
class Outputs:
    """What the timed path produced, on the host, for the reference."""

    detections: list  # [(frame n, q_WS of the predicted pose or None, [(uv (K, 2), mask (K,), desc (K, 16))])]
    hamming: list  # [(desc_a, desc_b, mask_a, mask_b, out)] numpy
    trajectory: tuple  # (stamps ns (N,), positions (N, 3), quaternions xyzw (N, 4)) of every published state
    posegraph: Optional[dict] = None  # where the pipeline runs the pose-graph layer: see posegraph_outputs


def posegraph_outputs(manager, taps: Taps, e0: int) -> dict:
    """The window's pose-graph outputs, `e0` being the graph's edge count
    when it opened: the sampled retrievals and solves (Taps), and every loop
    edge accepted in the window as (candidate's stamp, query's stamp,
    measured T_cand_query as r (3,) and q xyzw (4,))."""
    g = manager.graph
    edges = [(manager.timestamps[g.id_of[int(g.edge_i[e])]], manager.timestamps[g.id_of[int(g.edge_j[e])]],
              g.meas_r[e].copy(), g.meas_q[e].copy())
             for e in range(e0, g.n_edges) if g.edge_mask[e] and g.edge_kind[e] == 1]
    return dict(retrievals=list(taps.retrieval.items), solves=list(taps.solves.items), loop_edges=edges)


def collect_outputs(vio, taps: Taps, frame_of: dict, e0: Optional[int] = None) -> Outputs:
    dets = []
    for images, T_WS, frames in taps.detections.items:
        q = None if T_WS is None else T_WS.q.detach().cpu().double().numpy()
        dets.append((frame_of[id(images[0])], q, [(f.uv_np.copy(), f.mask_np.copy(), f.descriptors.cpu().numpy())
                                                 for f in frames]))
    host = lambda t: None if t is None else t.detach().cpu().numpy()  # noqa: E731
    ham = [tuple(host(t) for t in item) for item in taps.hamming.items]
    traj = vio.trajectory
    trajectory = (np.asarray([s.timestamp_ns for s in traj], np.int64),
                  np.stack([s.T_WS.r.numpy() for s in traj]) if traj else np.zeros((0, 3)),
                  np.stack([s.T_WS.q.numpy() for s in traj]) if traj else np.zeros((0, 4)))
    pg = None if vio.posegraph is None else posegraph_outputs(vio.posegraph, taps, e0)
    return Outputs(detections=dets, hamming=ham, trajectory=trajectory, posegraph=pg)


def run(workload: str, seed: int, seconds: float, traced: bool, t_process: float, device="cuda",
        warmup_frames: Optional[int] = None, prepare: Optional[Callable] = None,
        control: Optional[Callable] = None) -> tuple:
    """One run. Returns (the result object, the lines for standard error).
    `prepare(vio)` is called once the pipeline is built, before the taps
    (the fault tests break the timed path there); `warmup_frames` overrides
    the traffic's; `control(outputs, stream, config)`, when given, returns
    the control's readings, kept under the result's "control"."""
    from okvis_tpu_torch.pipeline import ThreadedVio
    from okvis_tpu_torch.utils import syncstats
    from okvis_tpu_torch.utils.timing import Timing

    cell = find_cell(workload)
    config = load_json(config_file(cell["config"]))
    traffic = load_json(traffic_file(cell["traffic"]))
    limits = load_json(limits_file(workload))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if config["dtype"] != "float32":
        raise ValueError(f"unsupported dtype {config['dtype']}")

    stream = world.make_stream(config, traffic, seed, dev)
    frame_of = {id(views[0]): i for i, views in enumerate(stream.views)}
    vio = ThreadedVio(vio_parameters(config), blocking=bool(config["blocking"]), dtype=torch.float32, device=dev)
    if prepare is not None:
        prepare(vio)
    taps = Taps(vio, seed, count_shapes=traced)
    lines = []
    try:
        warmup = traffic["warmup_frames"] if warmup_frames is None else warmup_frames
        n, imu_i = 0, 0
        for _ in range(warmup):
            imu_i, _ = feed(vio, stream, n, imu_i)
            n += 1

        # the window
        Timing.reset()
        syncs0 = syncstats.snapshot()
        e0 = None if vio.posegraph is None else vio.posegraph.graph.n_edges  # the window's first edge
        first = n
        taps.active = True
        t_w0 = time.perf_counter()
        latency = []
        while True:
            imu_i, dt = feed(vio, stream, n, imu_i)
            latency.append(dt)
            n += 1
            if time.perf_counter() - t_w0 >= seconds:
                break
        window_s = time.perf_counter() - t_w0
        taps.active = False
        frames = n - first
        syncs1 = syncstats.snapshot()
        stages = {k: acc.total for k, acc in Timing._timers.items()}
        stages_n = {k: acc.count for k, acc in Timing._timers.items()}
        memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        published = sum(1 for s in vio.trajectory if s.timestamp_ns >= stream.frame_ns(first))
        outputs = collect_outputs(vio, taps, frame_of, e0)

        e2e = {"frames_per_s": frames / window_s, "frame_ms.p90": 1e3 * float(np.percentile(latency, 90)),
               "setup_s": t_w0 - t_process}
        lines.append(f"window: {frames} frames in {window_s:.3f} s, frame ms p50 "
                     f"{1e3 * float(np.median(latency)):.1f} p90 {e2e['frame_ms.p90']:.1f} "
                     f"max {1e3 * max(latency):.1f} over {len(latency)} frames; {published} states published; "
                     f"setup {e2e['setup_s']:.2f} s")

        record = None
        if traced:
            record = dict(frames=frames, stages_s=stages, stages_n=stages_n,
                          syncs={k: syncs1.get(k, 0) - syncs0.get(k, 0) for k in syncs1})
            if on_card:
                record["trace"], n = profile_stretch(vio, taps, stream, n, imu_i)
                record["kernels"] = time_kernel_shapes(taps.shapes, stream, dev)
    finally:
        taps.close()
        vio.shutdown()  # stops every stage; re-raises a stage's error
    del vio, taps
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.set_num_threads(len(os.sched_getaffinity(0)))  # the reference, after the window, on every core

    checks = check.compare(outputs, stream, config, limits)
    control_readings = None if control is None else control(outputs, stream, config)
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result = dict(correct=correct, attempted=frames, failed=frames - published)
    if traced:
        result["metrics"] = {}
        for m in cell_metrics(workload, "per_layer"):
            v = metric_reader(m["name"])(record)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell_metrics(workload, "end_to_end")}
    result["device"] = dict(platform="gpu" if on_card else "cpu",
                            kind=torch.cuda.get_device_name(dev) if on_card else "cpu",
                            count=1, memory_peak_bytes=int(memory_peak))
    if traced and record.get("trace"):
        tr = record["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        lines.append(f"trace: {tr['frames']} frames, busy {tr['busy_s']:.4f} s of {tr['window_s']:.4f} s, "
                     f"{tr['launches']} device operations")
    if traced:
        lines.append("kernels: " + json.dumps(record.get("kernels")))
    if control_readings is not None:
        result["control"] = control_readings
    lines.append(f"compared: {len(outputs.detections)} frames' detections, {len(outputs.hamming)} distance "
                 f"matrices, {len(outputs.trajectory[0])} published states")
    lines += [f"check {k}: {c['value']} limit {c['limit']}" for k, c in checks.items()]
    result["checks"] = checks
    return result, lines


def profile_stretch(vio, taps: Taps, stream: world.Stream, n: int, imu_i: int) -> tuple:
    """STRETCH_FRAMES more frames under torch.profiler, each layer's call
    in a host span: the device's busy seconds (union), launches, top
    operations and idle gaps by host span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    taps.spans, taps.spans_on = [], True
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.MARK):
            t_mark = time.perf_counter_ns()
        t0 = time.perf_counter_ns()
        for _ in range(STRETCH_FRAMES):
            s0 = time.perf_counter_ns()
            imu_i, _ = feed(vio, stream, n, imu_i)
            taps.spans.append(("feed and wait_idle", s0, time.perf_counter_ns()))
            n += 1
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    taps.spans_on = False
    dev_events, mark = trace.events(prof)
    off = 0 if mark is None else mark - t_mark  # host clock -> the trace's clock
    spans = [(name, s + off, e + off) for name, s, e in taps.spans]
    out = trace.summary(dev_events, t0 + off, t1 + off, spans)
    out["frames"] = STRETCH_FRAMES
    if mark is None:
        out["idle_gaps"] = [["not attributed: no marker in the trace", sum(v for _, v in out["idle_gaps"])]]
    return out, n
