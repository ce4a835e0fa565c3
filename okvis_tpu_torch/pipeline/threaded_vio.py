"""The VIO pipeline: host stages in threads around the port's device programs
(port of okvis_tpu.pipeline.threaded_vio).

The reference's ThreadedKFVio (okvis_multisensor_processing
ThreadedKFVio.cpp): the same stage graph (per-camera detection, matching,
optimization, publishing) connected by bounded queues with the reference's
shedding policies (drop stale images :198-204, drop-oldest on full queues
:224-226, size-1 backpressure in blocking mode :312-319), with one worker
thread a stage. Input API of okvis::VioInterface (VioInterface.hpp:66-321):
add_image / add_imu_measurement, blocking mode, state callbacks, CSV
writers.

Device and threads: every stage launches on the estimator's device (the
CUDA card unless the caller passes device="cpu"), on the default stream,
which all worker threads share, so launches are ordered by the host. In
blocking mode with wait_idle after each frame, one frame is in flight at a
time, so the frontend's RANSAC generator and IdProvider see the calls in
the order of a single-threaded loop and a rerun repeats bit for bit.

Two departures from the JAX package, both so that a fault on the card
cannot pass for a quiet pipeline:
- a worker thread that raises stores the first exception and stops the
  pipeline; wait_idle and shutdown re-raise it, and wait_idle raises
  TimeoutError when the pipeline does not go idle in time (the JAX
  package's workers end silently and its wait_idle returns at the timeout);
- the processing stage drops a frame only on the estimator's own
  WindowFullError (the JAX package drops on any RuntimeError or ValueError,
  which in PyTorch would include a failed launch or an exhausted card).

The pose-graph layer (params.posegraph.enabled) runs in the processing
thread on keyframes only, in float64 on the pipeline's device; it reads the
estimator and never writes it, so the states are the same with it on or
off. With distributed_devices > 0 the estimator solves every window as
the sharded BA over that many devices (Estimator.enable_distributed):
distinct cards, or CPU shards when the pipeline runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import pickle
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import kinematics as kin
from ..cameras.ncamera import NCameraSystem
from ..config.parameters import VioParameters
from ..config.yaml_reader import build_imu_params, build_rig
from ..device import resolve_device
from ..estimator.estimator import Estimator, WindowFullError, device_get
from ..frontend.frame import MultiFrame
from ..frontend.frontend import Frontend, FrontendConfig
from ..imu.preintegration import init_pose_from_imu
from ..solver.structure import WindowConfig
from ..utils import syncstats, timing
from ..utils.ids import IdProvider
from ..utils.timing import Timer, Timing, Tracer
from .queues import ShutdownError, ThreadSafeQueue
from .synchronizer import FrameSynchronizer, ImuFrameSynchronizer

NS = 1_000_000_000
IMU_OVERLAP_NS = 20_000_000  # ±0.02 s slice overlap (ThreadedKFVio.cpp:52-53)

_log = logging.getLogger("okvis_tpu_torch")


@dataclasses.dataclass
class StateEstimate:
    """An optimized state: T_WS as float64 CPU tensors, speed and bias as a
    float64 numpy (9,)."""

    timestamp_ns: int
    T_WS: kin.SE3
    speed_and_bias: np.ndarray
    is_keyframe: bool = False


class ThreadedVio:
    """Pipeline runtime. In blocking mode every add_* call backpressures until
    the measurement is consumed (deterministic dataset processing, the mode
    used for benchmarks, ThreadedKFVio.cpp:312-319).

    `device` defaults to the CUDA card and raises without one; pass
    device="cpu" to run on the CPU. A given `rig` must live on that device.
    `dtype` is the estimator's float type."""

    def __init__(
        self,
        params: VioParameters,
        rig: Optional[NCameraSystem] = None,
        blocking: bool = True,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = params
        # online extrinsics calibration when the config provides absolute
        # extrinsic sigmas (ref Estimator.cpp:287-307; 0.0 = fixed); when
        # BOTH relative sigmas are set, per-state (temporally varying)
        # extrinsics blocks linked by relative-pose drift factors
        # (Estimator.cpp:199-218, 306-340)
        sig_t = params.camera_params.sigma_absolute_translation
        sig_r = params.camera_params.sigma_absolute_orientation
        rel_t = params.camera_params.sigma_c_relative_translation
        rel_r = params.camera_params.sigma_c_relative_orientation
        online_calib = sig_t > 1e-8 and sig_r > 1e-8
        per_state = rel_t > 1e-12 and rel_r > 1e-12
        if (rel_t > 1e-12) != (rel_r > 1e-12):
            _log.warning(
                "only one of sigma_c_relative_translation/orientation is nonzero — temporal extrinsics "
                "calibration needs BOTH (ref Estimator.cpp:199-205); treating extrinsics as temporally constant")

        self.rig = rig or build_rig(params, device=self.device)
        if self.rig.device.type != self.device.type:
            raise ValueError(f"ThreadedVio: the rig is on {self.rig.device}, the pipeline on {self.device}")
        self.imu_params = build_imu_params(params, device=self.device, dtype=dtype)
        cfg = None
        if per_state:
            S = params.optimization.num_keyframes + params.optimization.num_imu_frames + 1
            cfg = WindowConfig(
                num_states=S,
                num_cameras=self.rig.num_cameras,
                camera_specs=tuple(self.rig.specs),
                max_imu_links=S - 1,
                extrinsics_per_state=True,
                sigma_c_relative_translation=rel_t,
                sigma_c_relative_orientation=rel_r,
                sigma_absolute_translation=sig_t,
                sigma_absolute_orientation=sig_r,
            )
        self.estimator = Estimator(
            self.rig,
            self.imu_params,
            num_keyframes=params.optimization.num_keyframes,
            num_imu_frames=params.optimization.num_imu_frames,
            cfg=cfg,
            estimate_extrinsics=online_calib and not per_state,
            dtype=dtype,
            device=self.device,
        )
        if online_calib and not per_state:
            self.estimator.add_extrinsics_prior(sig_t, sig_r)
        if params.optimization.distributed_devices > 0:
            # sharded BA over a device mesh (config `distributed: devices: N`)
            self.estimator.enable_distributed(n_devices=params.optimization.distributed_devices)
        # online calibration: the matching/triangulation gates must admit
        # the image-space error an uncalibrated rig produces (~focal x
        # sigma_absolute_orientation px), the static-prior analog of the
        # reference feeding its pose/extrinsics covariance into the matcher
        # (VioKeyframeWindowMatchingAlgorithm doSetup :127-141)
        gate_extra_px = 0.0
        if online_calib:
            focal = max(float(i[0]) for i in self.rig.intrinsics)
            gate_extra_px = focal * sig_r + focal * sig_t / 4.0
        self.frontend = Frontend(
            self.rig,
            FrontendConfig(
                detection_threshold=params.optimization.detection_threshold,
                detection_octaves=params.optimization.detection_octaves,
                max_keypoints=params.optimization.max_num_keypoints,
                gate_extra_px=gate_extra_px,
            ),
        )
        self.blocking = blocking

        # optional pose-graph / loop-closure layer (the JAX package's
        # extension; the reference has none): fed cam 0 of each keyframe in
        # the processing thread; the solve runs only on verified loops
        self.posegraph = None
        if params.posegraph.enabled:
            from ..posegraph.manager import PoseGraphConfig, PoseGraphManager

            pg = params.posegraph
            self.posegraph = PoseGraphManager(
                PoseGraphConfig(score_threshold=pg.score_threshold, min_gap=pg.min_gap, min_inliers=pg.min_inliers,
                                node_capacity=pg.node_capacity, edge_capacity=pg.edge_capacity,
                                focal=float(self.rig.intrinsics[0][0]),
                                db_kp_capacity=params.optimization.max_num_keypoints, desc_words=16,
                                desc_dtype=np.uint32),
                T_SC=(self.rig.T_SC.r[0].cpu().numpy().astype(np.float64),
                      self.rig.T_SC.q[0].cpu().numpy().astype(np.float64)),
                device=self.device)
            if self.device.type == "cuda":
                # what the card builds at the first verification and solve
                # is built here, before the first frame
                self.posegraph.warm_up()
        # called with each accepted LoopEvent
        self.loop_closure_callback: Optional[Callable] = None

        # queues (ThreadedKFVio.hpp:343-375)
        self.camera_queues = [ThreadSafeQueue() for _ in range(self.rig.num_cameras)]
        self.keypoint_queue = ThreadSafeQueue()
        self.imu_queue = ThreadSafeQueue()
        self.result_queue = ThreadSafeQueue()

        self.frame_synchronizer = FrameSynchronizer(
            self.rig.num_cameras,
            tolerance_ns=int(params.camera_params.timestamp_tolerance * NS),
        )
        self.imu_synchronizer = ImuFrameSynchronizer()

        # IMU buffer (host lists of (ns, gyro, acc))
        self._imu_lock = threading.Lock()
        self._imu_ts: List[int] = []
        self._imu_gyro: List[np.ndarray] = []
        self._imu_acc: List[np.ndarray] = []

        self._last_added_ns = -1
        self._last_optimized: Optional[StateEstimate] = None
        self._state_lock = threading.Lock()
        # session epoch: estimator times are float64 seconds relative to the
        # first measurement, so float32 device arithmetic keeps sub-ms
        # resolution
        self._epoch_ns: Optional[int] = None
        # incremental propagation state for IMU-rate publishing: (t_ns, T_WS
        # and speed/bias on the estimator's device)
        self._prop_state = None
        self._reprop_needed = False
        self._last_opt_duration: Optional[float] = None
        # per-frame optimize() wall-clock latencies (p50/p99 reporting)
        self.opt_latencies: List[float] = []

        # callbacks (VioInterface.hpp:70-87)
        self.state_callback: Optional[Callable] = None
        self.full_state_callback: Optional[Callable] = None
        self.landmarks_callback: Optional[Callable] = None
        # IMU-rate propagated-state publishing (ref imuConsumerLoop,
        # ThreadedKFVio.cpp:542-601): called (t_ns, T_WS, speed_and_bias),
        # host values, for every IMU sample once an optimized state exists
        self.propagated_state_callback: Optional[Callable] = None
        # landmarks leaving the window (ref transferredLandmarks,
        # ThreadedKFVio.cpp:304): called (t_ns, {lm_id: hp_W})
        self.transferred_landmarks_callback: Optional[Callable] = None

        self.trajectory: List[StateEstimate] = []  # every optimized state
        self._position_measurements: List[tuple] = []  # buffered, unused (ref parity)
        self._csv_writers: Dict[object, object] = {}

        # quiescence counters for wait_idle, written by several threads;
        # every change is signalled on `_counted`, which wait_idle sleeps on
        self._counted = threading.Condition()
        self._images_fed = 0
        self._images_consumed = 0
        self._frames_enqueued = 0
        self._frames_processed = 0
        # the first exception a worker thread raised
        self._error: Optional[BaseException] = None
        # the span tree of each frame while tracing is on (set_tracing)
        self._tracer = Tracer()

        self._running = True
        self._threads: List[threading.Thread] = []
        self._start_threads()

    def _count(self, name: str, n: int = 1) -> None:
        with self._counted:
            setattr(self, name, getattr(self, name) + n)
            self._counted.notify_all()

    # ------------------------------------------------------------------
    # VioInterface inputs
    # ------------------------------------------------------------------
    def add_image(self, timestamp_ns: int, cam_idx: int, image) -> bool:
        """Drops images older than the last added frame minus the frame
        timestamp tolerance (ThreadedKFVio.cpp:197-204: the reference
        compares against frameTimestampTolerance and assigns, not maxes,
        so skewed multi-camera feeds within the tolerance pass)."""
        tol_ns = int(self.params.camera_params.timestamp_tolerance * NS)
        if timestamp_ns < self._last_added_ns - tol_ns:
            return False
        self._last_added_ns = timestamp_ns
        self._tracer.image_added(timestamp_ns)
        q = self.camera_queues[cam_idx]
        item = (timestamp_ns, cam_idx, image)
        self._count("_images_fed")
        if self.blocking:
            ok = q.push_blocking_if_full(item, 1)
            if not ok:
                self._count("_images_consumed")  # never entered the pipeline
            return ok
        if q.push_nonblocking_dropping_if_full(item, 1):
            self._count("_images_consumed")  # an old image was dropped
        return True

    # -- extension points of the reference API surface. The reference buffers
    # position measurements unused and throws on the rest
    # (ThreadedKFVio.cpp:231-241, 285-308); mirrored here.
    def add_keypoints(self, timestamp_ns, cam_idx, keypoints, descriptors) -> bool:
        raise NotImplementedError(
            "external keypoint input is not implemented (matches reference "
            "ThreadedKFVio::addKeypoints, ThreadedKFVio.cpp:231-241)"
        )

    def add_position_measurement(self, timestamp_ns, position, covariance=None) -> bool:
        # buffered and unused, like the reference positionConsumerLoop
        self._position_measurements.append((int(timestamp_ns), np.asarray(position)))
        f = self._csv_writers.get("pos")
        if f is not None:
            p = np.asarray(position, np.float64)
            f.write(f"{int(timestamp_ns)}, {p[0]:.6f}, {p[1]:.6f}, {p[2]:.6f}\n")
        return True

    def add_gps_measurement(self, *a, **k):
        raise NotImplementedError("GPS input not implemented (matches reference)")

    def add_magnetometer_measurement(self, *a, **k):
        raise NotImplementedError("magnetometer input not implemented (matches reference)")

    def add_barometer_measurement(self, *a, **k):
        raise NotImplementedError("barometer input not implemented (matches reference)")

    def add_differential_pressure_measurement(self, *a, **k):
        raise NotImplementedError("differential pressure input not implemented (matches reference)")

    def set_blocking(self, blocking: bool) -> None:
        """ref VioInterface::setBlocking: blocking mode also implies
        unlimited optimization time (ThreadedKFVio.cpp:312-319)."""
        self.blocking = blocking

    def add_imu_measurement(self, timestamp_ns: int, gyro, acc) -> bool:
        item = (int(timestamp_ns), np.asarray(gyro, np.float64), np.asarray(acc, np.float64))
        f = self._csv_writers.get("imu")
        if f is not None:
            g, a = item[1], item[2]
            f.write(f"{item[0]}, {g[0]:.9f}, {g[1]:.9f}, {g[2]:.9f}, "
                    f"{a[0]:.9f}, {a[1]:.9f}, {a[2]:.9f}\n")
        if self.blocking:
            # consume synchronously: the IMU path is cheap
            self._consume_imu(item)
            return True
        self.imu_queue.push_nonblocking_dropping_if_full(item, 2000)
        return True

    # ------------------------------------------------------------------
    def _to_sec(self, ns: int) -> float:
        if self._epoch_ns is None:
            self._epoch_ns = int(ns)
        return (int(ns) - self._epoch_ns) / NS

    def _consume_imu(self, item) -> None:
        ts, gyro, acc = item
        if self._epoch_ns is None:
            self._epoch_ns = int(ts)
        with self._imu_lock:
            if self._imu_ts and ts <= self._imu_ts[-1]:
                return  # enforce monotone timestamps (ThreadedKFVio.cpp:554-557)
            self._imu_ts.append(ts)
            self._imu_gyro.append(gyro)
            self._imu_acc.append(acc)
        self.imu_synchronizer.got_imu_data(ts)
        if self.propagated_state_callback is not None:
            self._publish_propagated(ts)

    def _publish_propagated(self, t_ns: int) -> None:
        """Incremental IMU-rate state propagation + publish (ref
        imuConsumerLoop, ThreadedKFVio.cpp:542-601): normally one short
        propagation step from the previous propagated state; whenever a new
        optimized state lands (repropagationNeeded_), restart from it and
        replay the buffered IMU in window-sized chunks. The propagation runs
        on the estimator's device with its inputs uploaded first; the
        published sample is one device-to-host copy (syncstats
        `propagate_publish`)."""
        base = self._last_optimized
        if base is None:
            return
        est = self.estimator
        if self._reprop_needed or self._prop_state is None:
            self._prop_state = (
                base.timestamp_ns,
                kin.SE3(r=est._t(base.T_WS.r), q=est._t(base.T_WS.q)),
                est._t(base.speed_and_bias),
            )
            self._reprop_needed = False
        t0_ns, T, sb = self._prop_state
        if t_ns <= t0_ns:
            return
        P = est.cfg.imu_samples
        epoch = self._epoch_ns or 0
        # replay in chunks the padded preintegration window can hold
        while t0_ns < t_ns:
            imu_ts, gyro, acc = self._get_imu_slice(t0_ns, t_ns)
            if len(imu_ts) < 2:
                break
            if len(imu_ts) > P:
                imu_ts, gyro, acc = imu_ts[:P], gyro[:P], acc[:P]
                t_chunk = int(imu_ts[-2])  # leave overlap for the next chunk
            else:
                t_chunk = t_ns
            if t_chunk <= t0_ns:
                break
            ts_p, gy_p, ac_p = est._pad_imu((imu_ts - epoch) / NS, gyro, acc, P)
            T, sb = est._propagate_fn(
                T, sb, est._t(ts_p), est._t(gy_p), est._t(ac_p),
                est._t((t0_ns - epoch) / NS), est._t((t_chunk - epoch) / NS))
            t0_ns = t_chunk
        self._prop_state = (t0_ns, T, sb)
        with syncstats.sync("propagate_publish"):
            r, q, sb_h = device_get((T.r, T.q, sb))
        self.propagated_state_callback(
            t_ns, kin.SE3(r=torch.from_numpy(np.array(r, np.float64)), q=torch.from_numpy(np.array(q, np.float64))),
            np.array(sb_h, np.float64))

    def _get_imu_slice(self, t0_ns: int, t1_ns: int):
        """IMU measurements covering [t0-0.02s, t1+0.02s]
        (ThreadedKFVio::getImuMeasurments, ThreadedKFVio.cpp:663-697)."""
        lo = t0_ns - IMU_OVERLAP_NS
        hi = t1_ns + IMU_OVERLAP_NS
        with self._imu_lock:
            ts = np.asarray(self._imu_ts, dtype=np.int64)
            i0 = int(np.searchsorted(ts, lo, side="left"))
            i1 = int(np.searchsorted(ts, hi, side="right"))
            i0 = max(0, i0 - 1)
            return (
                ts[i0:i1].copy(),
                np.stack(self._imu_gyro[i0:i1]) if i1 > i0 else np.zeros((0, 3)),
                np.stack(self._imu_acc[i0:i1]) if i1 > i0 else np.zeros((0, 3)),
            )

    def _trim_imu(self, before_ns: int) -> None:
        """Delete IMU measurements no longer needed
        (ThreadedKFVio.cpp:756-772)."""
        with self._imu_lock:
            ts = np.asarray(self._imu_ts, dtype=np.int64)
            keep = int(np.searchsorted(ts, before_ns - 2 * IMU_OVERLAP_NS, side="left"))
            if keep > 0:
                del self._imu_ts[:keep]
                del self._imu_gyro[:keep]
                del self._imu_acc[:keep]

    # ------------------------------------------------------------------
    # pipeline stages
    # ------------------------------------------------------------------
    def _start_threads(self) -> None:
        loops = [(self._frame_consumer_loop, (cam,)) for cam in range(self.rig.num_cameras)]
        loops += [(self._processing_loop, ()), (self._publisher_loop, ())]
        if not self.blocking:
            loops.append((self._imu_consumer_loop, ()))
        for loop, args in loops:
            t = threading.Thread(target=self._run_worker, args=(loop, *args), daemon=True)
            t.start()
            self._threads.append(t)

    def _run_worker(self, loop, *args) -> None:
        """A stage's thread: the loop until shutdown. An exception ends the
        pipeline, not only the thread: it is kept for wait_idle and shutdown
        to re-raise, and every queue is shut so no feeder blocks on a stage
        that is gone."""
        try:
            loop(*args)
        except Exception as e:  # the thread's boundary: recorded, re-raised by wait_idle / shutdown
            _log.exception("ThreadedVio: %s failed", loop.__name__)
            with self._counted:
                if self._error is None:
                    self._error = e
                self._counted.notify_all()
            self._stop()

    def _imu_consumer_loop(self) -> None:
        while self._running:
            try:
                item = self.imu_queue.pop_blocking()
            except ShutdownError:
                return
            self._consume_imu(item)

    def _frame_consumer_loop(self, cam: int) -> None:
        """Detection stage (frameConsumerLoop, ThreadedKFVio.cpp:322-453)."""
        tol_ns = int(self.params.camera_params.timestamp_tolerance * NS)
        while self._running:
            try:
                ts, cam_idx, image = self.camera_queues[cam].pop_blocking()
            except ShutdownError:
                return
            with self._state_lock:
                group = self.frame_synchronizer.add_frame(ts, cam_idx, image)
            if group is None:
                self._count("_images_consumed")
                continue
            with self._tracer.frame(group["timestamp_ns"], start=True, tolerance_ns=tol_ns):
                self._detect(group)

    def _detect(self, group: dict) -> None:
        """A complete camera group: wait until the IMU covers it, detect
        and describe, and hand the multiframe to the processing stage."""
        est = self.estimator
        self._count("_frames_enqueued")
        # wait until IMU covers this frame (ImuFrameSynchronizer.cpp:64-75)
        with timing.span("wait.imu"):
            covered = self.imu_synchronizer.wait_for_up_to_date_imu_data(
                group["timestamp_ns"] + IMU_OVERLAP_NS, timeout=5.0)
        if not covered:
            # dropped before reaching the processing stage: balance the
            # quiescence counters so wait_idle does not spin forever
            self._tracer.close_frame(group["timestamp_ns"], dropped=True)
            self._count("_frames_enqueued", -1)
            self._count("_images_consumed")
            return
        # predicted pose for gravity-aligned extraction; before any
        # optimized state exists, gravity-align from the IMU buffer (ref
        # initPoseFromImu in frameConsumerLoop, ThreadedKFVio.cpp:397-412),
        # else the first keyframe's descriptors use a different
        # extraction angle than every later frame and never match them
        last = self._last_optimized
        if last is not None:
            T_WS_pred = last.T_WS
        else:
            T_WS_pred = None
            _ts, _gy, acc = self._get_imu_slice(group["timestamp_ns"] - NS, group["timestamp_ns"] + IMU_OVERLAP_NS)
            if len(_ts) >= 2:
                with syncstats.sync("upload"):
                    acc_mean = torch.as_tensor(acc.mean(axis=0), dtype=est.dtype, device=est.device)
                T_WS_pred = init_pose_from_imu(acc_mean)
        with Timer("1.x detectAndDescribe"):
            images = [group["images"][c] for c in sorted(group["images"].keys())]
            frames = self.frontend.detect_and_describe_multi(images, T_WS_pred)
        mf = MultiFrame(id=IdProvider.new_id(), timestamp=group["timestamp_ns"] / NS, frames=frames)
        mf.timestamp_ns = group["timestamp_ns"]
        # only the group-completing image is still unaccounted (the
        # earlier ones were counted when their add_frame returned None)
        self._count("_images_consumed")
        timing.begin("wait.keypoints")
        self.keypoint_queue.push_blocking_if_full(mf, 1)

    def _processing_loop(self) -> None:
        """Matching + optimization + marginalization (matchingLoop +
        optimizationLoop, ThreadedKFVio.cpp:456-539, 720-854)."""
        while self._running:
            try:
                mf: MultiFrame = self.keypoint_queue.pop_blocking()
            except ShutdownError:
                return
            with self._tracer.frame(mf.timestamp_ns):
                timing.end("wait.keypoints")
                self._process(mf)

    def _process(self, mf: MultiFrame) -> None:
        """One multiframe through the back end, its state published.
        _frames_processed is counted at every exit (drop paths and
        completion): wait_idle must not report quiescence while a frame is
        mid-optimization."""
        est = self.estimator
        ts_ns = mf.timestamp_ns
        epoch0 = self._epoch_ns or 0
        last_ns = epoch0 + int(est._last_state().timestamp * NS) if est.states else ts_ns
        imu_ts, gyro, acc = self._get_imu_slice(min(last_ns, ts_ns), ts_ns)
        if len(imu_ts) < 2:
            self._tracer.close_frame(ts_ns, id=mf.id, dropped=True)
            self._count("_frames_processed")
            return
        with Timer("2.1 addStates"):
            try:
                epoch = self._epoch_ns or 0
                # defer_fetch: the propagated pose stays on the device
                # and rides the association's one fetch
                sid = est.add_states(
                    self._to_sec(ts_ns),
                    (imu_ts - epoch) / NS,
                    gyro,
                    acc,
                    as_keyframe=False,
                    frame_id=mf.id,
                    defer_fetch=True,
                )
            except WindowFullError:
                # "Failed to add state! will drop multiframe."
                # (ThreadedKFVio.cpp:512)
                sid = None
        if sid is None:
            self._tracer.close_frame(ts_ns, id=mf.id, dropped=True)
            self._count("_frames_processed")
            return
        est.multiframes[mf.id] = mf
        T_WS_prop, sb_prop = est.last_prop_device()
        with Timer("2.4 matching"):
            as_keyframe = self.frontend.data_association_and_initialization(est, T_WS_prop, mf, sb_prop=sb_prop)
        est.set_keyframe(sid, as_keyframe)
        self._write_tracks_csv(ts_ns, mf)
        with Timer("3.1 optimization"):
            # real-time knob (ref setOptimizationTimeLimit): non-blocking
            # mode runs the chunked wall-clock budget contract; blocking
            # mode runs full iterations (ThreadedKFVio.cpp:312-319)
            opt = self.params.optimization
            t0 = time.perf_counter()
            if self.blocking:
                est.optimize()
            else:
                est.optimize(time_limit=opt.time_limit, min_iterations=opt.min_iterations,
                             max_iterations=opt.max_iterations)
            self._last_opt_duration = time.perf_counter() - t0
            self.opt_latencies.append(self._last_opt_duration)
        with Timer("3.2 marginalization"):
            removed_hp = (
                {lm_id: est.get_landmark(lm_id) for lm_id in list(est.landmarks.keys())}
                if self.transferred_landmarks_callback
                else None
            )
            removed = est.apply_marginalization_strategy()
            if removed and removed_hp is not None:
                self.transferred_landmarks_callback(
                    ts_ns, {i: removed_hp[i] for i in removed if i in removed_hp})
        # IMU links own their sample copies, so the buffer only serves
        # new-frame slices and repropagation: trim to a margin behind the
        # newest state (ref deleteImuMeasurements, ThreadedKFVio.cpp:756-772)
        self._trim_imu(epoch0 + int(est._states_by_time()[-1].timestamp * NS) - NS // 2)

        if self.posegraph is not None and as_keyframe:
            with Timer("3.3 posegraph"):
                self._feed_posegraph(est, sid, mf, ts_ns)

        result = StateEstimate(
            timestamp_ns=ts_ns,
            T_WS=est.get_T_WS(sid),
            speed_and_bias=est.get_speed_and_bias(sid),
            is_keyframe=as_keyframe,
        )
        with self._state_lock:
            self._last_optimized = result
            self._reprop_needed = True  # repropagationNeeded_ (ref :774-794)
            self.trajectory.append(result)
        self.result_queue.push_nonblocking_dropping_if_full(result, 10)
        self._tracer.close_frame(ts_ns, id=mf.id, keyframe=as_keyframe)
        self._count("_frames_processed")

    def _feed_posegraph(self, est: Estimator, sid: int, mf: MultiFrame, ts_ns: int) -> None:
        """Hand the new keyframe's camera 0 to the pose-graph layer: its
        descriptors (one device-to-host copy), unit bearings
        (back-projection) and the world positions of its initialized
        landmarks, under the Timer `posegraph.feed` (in a traced frame its
        span carries the count of valid landmarks handed over)."""
        from ..frontend import kernels

        with Timer("posegraph.feed"):
            f = mf.frames[0]
            desc = f.descriptors.cpu().numpy().view(np.uint32)  # (K, 16)
            mask = f.mask_np.copy()
            uv = f.uv_np
            K = desc.shape[0]
            rays = kernels.back_project_batch(
                self.rig.specs[0], self.rig.intrinsics[0], torch.as_tensor(uv, device=self.device)).cpu().numpy()
            bearings = rays / np.maximum(np.linalg.norm(rays, axis=1, keepdims=True), 1e-12)

            lms_W = np.zeros((K, 3))
            lm_valid = np.zeros(K, bool)
            for k in range(K):
                lm_id = int(f.landmark_ids[k])
                if lm_id == 0 or not mask[k]:
                    continue
                rec = est.landmarks.get(lm_id)
                if rec is None or not rec.initialized:
                    continue
                hp = est.get_landmark(lm_id)
                if abs(hp[3]) < 1e-8:
                    continue
                lms_W[k] = hp[:3] / hp[3]
                lm_valid[k] = True

            T = est.get_T_WS(sid)
            timing.annotate("posegraph.feed", valid_landmarks=int(lm_valid.sum()))
        event = self.posegraph.add_keyframe(
            kf_id=mf.id, timestamp_ns=ts_ns, r_WS_vio=T.r.numpy(), q_WS_vio=T.q.numpy(), descriptors=desc,
            desc_mask=mask, bearings_C=bearings, landmarks_W=lms_W, lm_valid=lm_valid)
        if self.params.posegraph.cull_redundant:
            self.posegraph.cull_redundant()
        if event is not None and event.accepted and self.loop_closure_callback is not None:
            self.loop_closure_callback(event)

    def _publisher_loop(self) -> None:
        """Callback publishing (publisherLoop, ThreadedKFVio.cpp:857-878).
        Runs until its queue is shut and drained, so every state reaches the
        callbacks and the state CSV before shutdown returns."""
        while True:
            try:
                result: StateEstimate = self.result_queue.pop_blocking()
            except ShutdownError:
                return
            if self.state_callback:
                self.state_callback(result.timestamp_ns, result.T_WS)
            if self.full_state_callback:
                self.full_state_callback(result.timestamp_ns, result.T_WS, result.speed_and_bias)
            if "state" in self._csv_writers:
                w = self._csv_writers["state"]
                r = result.T_WS.r.numpy()
                q = result.T_WS.q.numpy()
                sb = result.speed_and_bias
                w.write(
                    f"{result.timestamp_ns},{r[0]},{r[1]},{r[2]},"
                    f"{q[0]},{q[1]},{q[2]},{q[3]},"
                    + ",".join(str(x) for x in sb) + "\n"
                )
            if self.landmarks_callback:
                # publish only well-constrained landmarks
                # (ref landmarkQualityThreshold, ThreadedKFVio publishing)
                thr = self.params.publishing.landmark_quality_threshold
                lms = {}
                for lm_id, rec in list(self.estimator.landmarks.items()):
                    if rec.quality >= thr:
                        try:
                            lms[lm_id] = self.estimator.get_landmark(lm_id)
                        except KeyError:
                            pass
                self.landmarks_callback(result.timestamp_ns, lms)

    # ------------------------------------------------------------------
    def set_state_csv_file(self, path: str) -> None:
        """ref VioInterface CSV writers (VioInterface.hpp:95-123): stream the
        optimized states to CSV (ts_ns, p_WS, q_WS(xyzw), v, b_g, b_a)."""
        f = open(path, "w")
        f.write("#timestamp_ns,p_x,p_y,p_z,q_x,q_y,q_z,q_w,"
                "v_x,v_y,v_z,b_gx,b_gy,b_gz,b_ax,b_ay,b_az\n")
        self._csv_writers["state"] = f

    def set_imu_csv_file(self, path: str) -> None:
        """Raw IMU stream (ref setImuCsvFile + writeImuCsvDescription,
        VioInterface.cpp:109-121; the reference registers the file but never
        streams rows; here every accepted measurement is written)."""
        f = open(path, "w")
        f.write("timestamp, omega_tilde_WS_S_x, omega_tilde_WS_S_y, "
                "omega_tilde_WS_S_z, a_tilde_WS_S_x, a_tilde_WS_S_y, "
                "a_tilde_WS_S_z\n")
        self._csv_writers["imu"] = f

    def set_pos_csv_file(self, path: str) -> None:
        """Position-measurement stream (ref setPosCsvFile,
        VioInterface.cpp:122-131)."""
        f = open(path, "w")
        f.write("timestamp, pos_E, pos_N, pos_U\n")
        self._csv_writers["pos"] = f

    def set_mag_csv_file(self, path: str) -> None:
        """Magnetometer stream (ref setMagCsvFile, VioInterface.cpp:133-142).
        Header-only in practice: the magnetometer input raises
        NotImplementedError, as the reference's does
        (ThreadedKFVio.cpp:296-308)."""
        f = open(path, "w")
        f.write("timestamp, mag_x, mag_y, mag_z\n")
        self._csv_writers["mag"] = f

    def set_tracks_csv_file(self, camera_idx: int, path: str) -> None:
        """Per-camera keypoint-track stream (ref setTracksCsvFile +
        writeTracksCsvDescription, VioInterface.cpp:144-153): one row per
        landmark-associated keypoint of every processed frame."""
        f = open(path, "w")
        f.write("timestamp, landmark_id, z_tilde_x, z_tilde_y, "
                "z_tilde_stdev, descriptor\n")
        self._csv_writers[("tracks", camera_idx)] = f

    def _write_tracks_csv(self, ts_ns: int, mf) -> None:
        for c in range(mf.num_cameras):
            f = self._csv_writers.get(("tracks", c))
            if f is None:
                continue
            fr = mf.frames[c]
            uv = fr.uv_np
            # descriptors as the JAX package's uint32 words
            desc = fr.descriptors.cpu().numpy().view(np.uint32)
            for k in np.nonzero(fr.landmark_ids != 0)[0]:
                stdev = fr.keypoint_size(int(k)) / 8.0
                f.write(
                    f"{ts_ns}, {int(fr.landmark_ids[k])}, {uv[k,0]:.4f}, "
                    f"{uv[k,1]:.4f}, {stdev:.3f}, {desc[k].tobytes().hex()}\n"
                )

    # ------------------------------------------------------------------
    # pipeline checkpoint / resume (absent in the reference): the
    # estimator's window, marginal prior and keyframe keypoint tables, the
    # session epoch, the initialization flag and the last optimized state,
    # enough to resume a long sequence in a fresh process. The frontend's
    # RANSAC generator starts again from its seed, as in the JAX package.
    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Write `path` (the pipeline) and `path`.est (the estimator,
        Estimator.save_checkpoint) once the pipeline is idle. The files are
        the port's own pickles of plain values and numpy arrays."""
        self.wait_idle()
        self.estimator.save_checkpoint(path + ".est")
        lo = self._last_optimized
        blob = dict(
            epoch_ns=self._epoch_ns,
            last_added_ns=self._last_added_ns,
            is_initialized=self.frontend.is_initialized,
            last_optimized=None if lo is None else dict(
                timestamp_ns=lo.timestamp_ns,
                r=lo.T_WS.r.numpy().copy(),
                q=lo.T_WS.q.numpy().copy(),
                sb=np.array(lo.speed_and_bias, np.float64),
                is_keyframe=lo.is_keyframe,
            ),
        )
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    def load_checkpoint(self, path: str) -> None:
        """Restore a save_checkpoint into a freshly constructed ThreadedVio
        (same config and rig) BEFORE feeding measurements; feed the IMU
        again from before the checkpoint's last state, since the IMU buffer
        is not saved. Unpickles the files: load only files this program
        wrote."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        self.estimator.load_checkpoint(path + ".est")
        self._epoch_ns = blob["epoch_ns"]
        self._last_added_ns = blob["last_added_ns"]
        self.frontend.is_initialized = blob["is_initialized"]
        lo = blob["last_optimized"]
        if lo is not None:
            self._last_optimized = StateEstimate(
                timestamp_ns=lo["timestamp_ns"],
                T_WS=kin.SE3(r=torch.from_numpy(lo["r"]), q=torch.from_numpy(lo["q"])),
                speed_and_bias=lo["sb"],
                is_keyframe=lo["is_keyframe"],
            )
            self._reprop_needed = True

    # ------------------------------------------------------------------
    # tracing (absent in the reference)
    # ------------------------------------------------------------------
    def set_tracing(self, on: bool = True) -> None:
        """Record a span tree for every frame whose camera group completes
        from now on (off by default; utils.timing): the stages, the waits
        for the IMU and between the threads, preintegration, the solve's
        enqueue, each blocking fetch (`sync.<tag>`) and the solver's
        iteration counts, in memory until export_trace."""
        self._tracer.enabled = on

    def export_trace(self) -> dict:
        """The spans of every traced frame that finished (published or
        dropped) since the last export, removed from memory
        (utils.timing.Tracer.export)."""
        return self._tracer.export()

    def _raise_worker_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("ThreadedVio: a pipeline stage failed") from self._error

    def wait_idle(self, timeout: float = 60.0) -> None:
        """Block until every fed measurement has fully traversed the pipeline
        (consumed, synchronized, matched, optimized). Raises the first error
        of a worker thread (as the cause of a RuntimeError), and
        TimeoutError when the pipeline is not idle after `timeout` s.

        The caller sleeps on the counters' condition, woken by each count
        and by a stage's error: it does not ask for the interpreter lock
        while the stages work."""
        deadline = time.monotonic() + timeout
        with self._counted:
            while True:
                self._raise_worker_error()
                if (self._images_consumed >= self._images_fed and self._frames_processed >= self._frames_enqueued
                        and all(len(q) == 0 for q in self.camera_queues) and len(self.keypoint_queue) == 0):
                    return
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ThreadedVio: not idle after {timeout} s")
                self._counted.wait(min(left, 0.1))

    def _stop(self) -> None:
        """Wake every blocked stage and feeder; the stages end."""
        self._running = False
        for q in self.camera_queues:
            q.shutdown()
        self.keypoint_queue.shutdown()
        self.imu_queue.shutdown()
        self.result_queue.shutdown()
        self.imu_synchronizer.shutdown()

    def shutdown(self) -> str:
        """Graceful shutdown: wait until idle, wake all blocked stages, join,
        close the CSV files, and return the timing table
        (ThreadedKFVio.cpp:152-189 + Timing::print). The pipeline stops
        and its files close even when waiting fails; a worker's error or
        the idle timeout is raised after that."""
        try:
            self.wait_idle()
        finally:
            self._stop()
            for t in self._threads:
                t.join(timeout=5.0)
            for f in self._csv_writers.values():
                f.close()
            self._csv_writers.clear()
        self._raise_worker_error()
        return Timing.print()
