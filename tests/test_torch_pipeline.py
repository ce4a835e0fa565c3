"""The port's pipeline on the CPU: mirrors of tests/test_pipeline.py (queues,
synchronizer, shutdown under load, config wiring, visualizer, PoseViewer)
and tests/test_utils.py:50 (the state CSV), with VioParameters built in
code, and the port's own error contract.

The JAX package's worker threads end silently on an exception and its
wait_idle returns at its timeout; the port's ThreadedVio re-raises a
worker's first exception from wait_idle and shutdown, raises TimeoutError
when not idle in time, and drops a frame only on the estimator's
WindowFullError, so a device fault can never pass for a dropped frame or a
quiet pipeline.
"""

import io
import logging
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu.config.parameters import VioParameters as JVioParameters
from okvis_tpu.pipeline import ThreadedVio as JThreadedVio
from okvis_tpu_torch import kinematics as kin
from okvis_tpu_torch.config import VioParameters
from okvis_tpu_torch.estimator.estimator import WindowFullError
from okvis_tpu_torch.pipeline import FrameSynchronizer, ThreadedVio, ThreadSafeQueue
from okvis_tpu_torch.pipeline.queues import ShutdownError
from okvis_tpu_torch.pipeline.threaded_vio import StateEstimate
from test_torch_estimator import jax_rig, port_rig

torch.set_num_threads(2)
NS = 1_000_000_000


# ---------------------------------------------------------------- queues
def test_queue_backpressure_and_drop():
    q = ThreadSafeQueue()
    q.push_nonblocking_dropping_if_full(1, 2)
    q.push_nonblocking_dropping_if_full(2, 2)
    dropped = q.push_nonblocking_dropping_if_full(3, 2)
    assert dropped
    assert q.pop_blocking() == 2  # 1 was dropped (oldest)
    assert q.pop_blocking() == 3


def test_queue_shutdown_wakes_consumer():
    q = ThreadSafeQueue()
    woke = []

    def consumer():
        try:
            q.pop_blocking()
        except ShutdownError:
            woke.append(True)

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.05)
    q.shutdown()
    t.join(timeout=2)
    assert woke == [True] and not t.is_alive()


# ---------------------------------------------------------------- synchronizer
def test_frame_synchronizer_groups_stereo():
    """testSynchronizer.cpp:24-128: correct order, missing frames,
    out-of-order tolerance."""
    fs = FrameSynchronizer(2, tolerance_ns=5_000_000)
    assert fs.add_frame(1000 * NS, 0, "a0") is None
    g = fs.add_frame(1000 * NS + 1_000_000, 1, "a1")
    assert g is not None and set(g["images"]) == {0, 1}
    # missing partner: group dropped after buffer overflow
    assert fs.add_frame(2000 * NS, 0, "b0") is None
    assert fs.add_frame(3000 * NS, 0, "c0") is None
    assert fs.add_frame(4000 * NS, 0, "d0") is None
    assert fs.add_frame(5000 * NS, 0, "e0") is None  # b0's group evicted
    g = fs.add_frame(5000 * NS + 100_000, 1, "e1")
    assert g is not None
    # far-apart timestamps never group
    fs2 = FrameSynchronizer(2, tolerance_ns=5_000_000)
    fs2.add_frame(0, 0, "x")
    assert fs2.add_frame(50_000_000, 1, "y") is None


# ---------------------------------------------------------------- the runtime
def _params(**camera_params):
    p = VioParameters()
    p.optimization.max_num_keypoints = 96
    for k, v in camera_params.items():
        setattr(p.camera_params, k, v)
    return p


def _vio(params=None, blocking=True):
    rig = port_rig()
    rig.overlaps = np.ones((2, 2), bool)
    return ThreadedVio(params or _params(), rig=rig, blocking=blocking, dtype=torch.float64, device="cpu")


def _feed_frame(vio, fi, img=np.zeros((480, 752), np.float32)):
    """A static IMU up to 25 ms past frame fi, then both images."""
    t_ns = int(fi * 0.1 * NS)
    for t in range(max(0, t_ns - 100_000_000), t_ns + 25_000_001, 5_000_000):
        vio.add_imu_measurement(t, np.zeros(3), np.asarray([0.0, 0.0, 9.81]))
    vio.add_image(t_ns, 0, img)
    vio.add_image(t_ns, 1, img)


def _joined(vio):
    for t in vio._threads:
        t.join(timeout=10)
    return not any(t.is_alive() for t in vio._threads)


def test_shutdown_under_load_nonblocking():
    """testThreading.cpp analog: clean construction/shutdown while
    measurements stream in non-blocking mode (queues shed, threads join)."""
    vio = _vio(blocking=False)
    stop = threading.Event()

    def feed_imu():
        t = 0
        while not stop.is_set():
            vio.add_imu_measurement(t, np.zeros(3), np.asarray([0, 0, 9.81]))
            t += 5_000_000
            time.sleep(0.0005)

    def feed_images():
        t = 0
        img = np.zeros((480, 752), np.float32)
        while not stop.is_set():
            vio.add_image(t, 0, img)
            vio.add_image(t, 1, img)
            t += 100_000_000
            time.sleep(0.005)

    threads = [threading.Thread(target=feed_imu), threading.Thread(target=feed_images)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    vio.shutdown()  # must not hang
    assert _joined(vio)


def test_config_wiring_matches_jax():
    """tests/test_pipeline.py:455's wiring: absolute extrinsics sigmas turn
    on online calibration with the JAX package's gate inflation; a single
    nonzero relative sigma warns and is ignored."""
    kw = dict(sigma_absolute_translation=0.05, sigma_absolute_orientation=0.02)
    jp = JVioParameters()
    for k, v in kw.items():
        setattr(jp.camera_params, k, v)
    jrig = jax_rig()
    jrig.overlaps = np.ones((2, 2), bool)
    jvio = JThreadedVio(jp, rig=jrig, blocking=True, dtype=jnp.float64)
    vio = _vio(_params(**kw))
    try:
        assert vio.estimator.cfg.estimate_extrinsics and jvio.estimator.cfg.estimate_extrinsics
        assert vio.frontend.cfg.gate_extra_px == jvio.frontend.cfg.gate_extra_px > 0
        assert vio.estimator.marg_valid and vio.estimator.fej_ext_frozen
        np.testing.assert_array_equal(vio.estimator.marg_H, np.asarray(jvio.estimator.marg_H))
    finally:
        vio.shutdown()
        jvio.shutdown()

    h = logging.StreamHandler(io.StringIO())
    logging.getLogger("okvis_tpu_torch").addHandler(h)
    try:
        vio2 = _vio(_params(sigma_c_relative_translation=1e-4))
        assert not vio2.estimator.cfg.estimate_extrinsics and vio2.frontend.cfg.gate_extra_px == 0.0
        assert "sigma_c_relative" in h.stream.getvalue()
        vio2.shutdown()
    finally:
        logging.getLogger("okvis_tpu_torch").removeHandler(h)


def _per_state(p):
    p.camera_params.sigma_c_relative_translation = 1e-4
    p.camera_params.sigma_c_relative_orientation = 1e-5


@pytest.mark.parametrize("mode,item", [
    (_per_state, None),
    (lambda p: setattr(p.optimization, "distributed_devices", 8), 8),
    (lambda p: setattr(p.posegraph, "enabled", True), None),
    (lambda p: setattr(p.optimization, "detection_octaves", 2), None),
], ids=["per_state_extrinsics", "distributed", "posegraph", "detection_octaves"])
def test_unported_modes_raise_at_construction(mode, item):
    """The mode ROADMAP item 8 leaves out (the distributed solve) raises at
    construction and starts no worker; those of item 6 (per-state
    extrinsics, scale-space detection) and item 7 (the pose graph) are
    ported and build."""
    p = _params()
    mode(p)
    n = threading.active_count()
    if item is None:
        vio = _vio(p)
        assert (vio.estimator.cfg.extrinsics_per_state or vio.frontend.cfg.detection_octaves == 2
                or vio.posegraph is not None)
        vio.shutdown()
        assert _joined(vio)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md item {item}"):
        _vio(p)
    assert threading.active_count() == n  # no worker was started


def test_rig_on_another_device_is_refused():
    rig = port_rig()
    with pytest.raises(ValueError, match="rig is on"):
        ThreadedVio(_params(), rig=rig, device="meta")


# ------------------------------------------------------------ error contract
def test_worker_exception_surfaces_at_wait_idle_and_shutdown():
    vio = _vio()

    def boom(*a, **k):
        raise ValueError("association failed")

    vio.frontend.data_association_and_initialization = boom
    _feed_frame(vio, 0)
    with pytest.raises(RuntimeError, match="stage failed") as err:
        vio.wait_idle(timeout=30)
    assert isinstance(err.value.__cause__, ValueError)
    # the pipeline stopped: a feeder is not blocked by a dead stage
    assert vio.add_image(10 * NS, 0, np.zeros((480, 752), np.float32)) is False
    with pytest.raises(RuntimeError, match="stage failed"):
        vio.shutdown()
    assert _joined(vio) and not vio._csv_writers


def test_device_error_in_add_states_is_not_a_dropped_frame():
    """A CUDA-style RuntimeError from add_states propagates: the JAX
    package's catch of RuntimeError would count it as a dropped frame."""
    vio = _vio()

    def launch_failure(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    vio.estimator.add_states = launch_failure
    _feed_frame(vio, 0)
    with pytest.raises(RuntimeError, match="stage failed") as err:
        vio.wait_idle(timeout=30)
    assert "illegal memory access" in str(err.value.__cause__)
    assert vio._frames_processed == 0 and not vio.trajectory
    with pytest.raises(RuntimeError):
        vio.shutdown()


def test_window_full_drops_the_frame():
    """The estimator's own refusal sheds the frame, as the reference does
    (ThreadedKFVio.cpp:512), and the pipeline goes on."""
    vio = _vio()
    orig = vio.estimator.add_states
    calls = []

    def refuse_once(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise WindowFullError("window full")
        return orig(*a, **k)

    vio.estimator.add_states = refuse_once
    for fi in range(3):
        _feed_frame(vio, fi)
        vio.wait_idle(timeout=60)
    vio.shutdown()
    assert len(calls) == 3 and vio._frames_processed == 3
    assert [s.timestamp_ns for s in vio.trajectory] == [0, 2 * NS // 10]


def test_wait_idle_times_out():
    vio = _vio()
    release = threading.Event()
    orig = vio.estimator.optimize

    def slow(*a, **k):
        release.wait(timeout=30)
        return orig(*a, **k)

    vio.estimator.optimize = slow
    _feed_frame(vio, 0)
    with pytest.raises(TimeoutError, match="not idle"):
        vio.wait_idle(timeout=0.3)
    release.set()
    vio.wait_idle(timeout=60)
    vio.shutdown()
    assert len(vio.trajectory) == 1


def test_quiescence_counters_lose_no_update_under_contention():
    """The counters wait_idle reads are written by the feeder, both frame
    consumers and the processing thread: more writers than cores, with the
    interpreter switching threads as often as it can, lose no increment."""
    import os
    import sys

    vio = _vio()
    n_threads, n = 2 * (os.cpu_count() or 2), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [vio._count("_images_consumed") for _ in range(n)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert vio._images_consumed == n_threads * n
    vio._images_fed = vio._images_consumed  # balanced: shutdown finds the pipeline idle
    vio.shutdown()


# ---------------------------------------------------------------- outputs
def test_state_csv_writer(tmp_path):
    """tests/test_utils.py:50: a state pushed through the publisher queue
    becomes one CSV row (VioInterface.hpp:95-123)."""
    vio = _vio()
    path = str(tmp_path / "states.csv")
    vio.set_state_csv_file(path)
    res = StateEstimate(
        timestamp_ns=123,
        T_WS=kin.SE3(r=torch.tensor([1.0, 2, 3], dtype=torch.float64), q=kin.quat_identity(device="cpu")),
        speed_and_bias=np.arange(9, dtype=float),
    )
    vio.result_queue.push_nonblocking_dropping_if_full(res, 10)
    vio.shutdown()  # the publisher drains its queue before it ends
    lines = open(path).read().strip().splitlines()
    assert lines[0].startswith("#timestamp_ns")
    assert len(lines) == 2
    fields = lines[1].split(",")
    assert fields[0] == "123"
    assert float(fields[1]) == 1.0 and float(fields[7]) == 1.0  # p_x, q_w
    assert [float(x) for x in fields[8:]] == list(range(9))


def test_visualizer_overlay():
    """VioVisualizer analog: colour-coded keypoint overlays render."""
    from okvis_tpu_torch.frontend.detection import Keypoints
    from okvis_tpu_torch.frontend.frame import FrameData, MultiFrame
    from okvis_tpu_torch.pipeline.visualizer import BLUE, GREEN, RED, draw_multiframe

    K = 8
    uv = torch.from_numpy(np.random.default_rng(0).uniform(10, 90, (K, 2)))
    f = FrameData(
        keypoints=Keypoints(uv=uv, score=torch.ones(K), mask=torch.ones(K, dtype=torch.bool)),
        descriptors=torch.zeros((K, 16), dtype=torch.int32),
        landmark_ids=np.zeros(K, np.int64),
        image=torch.full((100, 100), 100.0),
    )
    f.landmark_ids[0] = 7  # associated but unknown to the estimator -> blue
    imgs = draw_multiframe(MultiFrame(id=1, timestamp=0.0, frames=[f]))
    assert imgs[0].shape == (100, 100, 3) and imgs[0].dtype == np.uint8
    for colour in (RED, BLUE):
        assert (imgs[0] == colour).all(-1).any()
    assert not (imgs[0] == GREEN).all(-1).any()
    f.image = None
    assert draw_multiframe(MultiFrame(id=1, timestamp=0.0, frames=[f])) == [None]


class TestPoseViewer:
    """Headless PoseViewer analog (ref okvis_app_synchronous.cpp:55-195)."""

    def test_path_rendering_and_readout(self):
        from okvis_tpu_torch.pipeline.pose_viewer import PoseViewer

        v = PoseViewer(image_size=200)
        for i in range(50):
            a = i / 50 * 2 * np.pi
            T = kin.SE3(r=torch.tensor([np.cos(a), np.sin(a), 0.1 * i]), q=torch.tensor([0.0, 0.0, 0.0, 1.0]))
            sb = np.concatenate([[0.3, 0.0, 0.0], np.zeros(6)])
            v.publish_full_state_as_callback(i * 10**8, T, sb)
        img = v.render()
        assert img.shape == (200, 200, 3)
        # the path must actually be drawn (non-background pixels)
        assert (img != 255).any(axis=2).sum() > 100
        ro = v.last_readout()
        assert ro["n_states"] == 50
        assert abs(ro["speed_mps"] - 0.3) < 1e-9

    def test_render_equals_jax(self):
        from okvis_tpu.kinematics import se3 as jse3
        from okvis_tpu.pipeline.pose_viewer import PoseViewer as JPoseViewer
        from okvis_tpu_torch.pipeline.pose_viewer import PoseViewer

        v, jv = PoseViewer(image_size=120), JPoseViewer(image_size=120)
        rng = np.random.default_rng(3)
        for i, r in enumerate(np.cumsum(rng.normal(0, 0.2, (30, 3)), axis=0)):
            q = np.asarray([0.0, 0.0, 0.0, 1.0])
            sb = rng.normal(0, 1, 9)
            v.publish_full_state_as_callback(i, kin.SE3(r=torch.from_numpy(r), q=torch.from_numpy(q)), sb)
            jv.publish_full_state_as_callback(i, jse3.SE3(r=r, q=q), sb)
        v.add_loop_corrected(np.asarray(v.path) + 0.1)
        jv.add_loop_corrected(np.asarray(jv.path) + 0.1)
        np.testing.assert_array_equal(v.render(), jv.render())
        assert v.last_readout() == jv.last_readout()

    def test_empty_viewer_renders_blank(self):
        from okvis_tpu_torch.pipeline.pose_viewer import PoseViewer

        v = PoseViewer(image_size=64)
        assert (v.render() == 255).all()
        assert v.last_readout() is None

    def test_save_png(self, tmp_path):
        from okvis_tpu_torch.pipeline.pose_viewer import PoseViewer

        v = PoseViewer(image_size=64)
        for i in range(5):
            v.publish_full_state_as_callback(i, kin.SE3(r=torch.tensor([float(i), 0.0, 0.0]),
                                                        q=torch.tensor([0.0, 0.0, 0.0, 1.0])), np.zeros(9))
        p = tmp_path / "path.png"
        v.save(str(p))
        assert p.exists() and p.stat().st_size > 0
