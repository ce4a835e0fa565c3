"""The port's ThreadedVio against the JAX package's, in float64 on the CPU:
the slice as a whole.

Both runtimes run in blocking mode for 9 frames of a stub detector that
hands each the same numpy keypoint frames (datasets.synthetic.
keypoint_frames: trajectory seed 31, 600 landmarks at 4-8 m, K = 64, the
frames of test_torch_vio_loop.py and one more), on the EuRoC rig with overlaps, with
VioParameters built in code (the EuRoC defaults), the IMU fed 25 ms past
each frame, then both images, then wait_idle, as tests/test_pipeline.py
feeds. The JAX frontend's RANSAC keys are replayed into the port's
Frontend._draw.

Tolerances (measured gaps in brackets): every StateEstimate's timestamp and
keyframe flag exactly, T_WS and speed/bias to 1e-8 [window states
<= 3.8e-11, speed/bias <= 3.7e-10]; the keypoint-to-landmark ids exactly;
the window after every frame at test_torch_vio_loop.py's tolerances, but
landmark positions to 5e-8 [2.1e-8, on a landmark 11 m out with quality
4.8e-4: the runtime's default window runs 10 LM iterations where
test_torch_vio_loop.py's runs 5, and its 1e-8 does not hold]; the propagated
states to 1e-8; the transferred landmark ids exactly; the IMU, position and
track CSV files byte for byte. A checkpoint saved after the fifth frame
(the first with a marginal prior) restores the window exactly into a fresh
ThreadedVio, which continues the last 4 frames equal to the uninterrupted
run to 1e-8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu.config.parameters import VioParameters as JVioParameters
from okvis_tpu.pipeline import ThreadedVio as JThreadedVio
from okvis_tpu.utils.ids import IdProvider as JIds
from okvis_tpu_torch import convert
from okvis_tpu_torch.config import VioParameters
from okvis_tpu_torch.datasets.synthetic import keypoint_frames, make_landmarks, simulate_trajectory
from okvis_tpu_torch.pipeline import ThreadedVio
from okvis_tpu_torch.utils.ids import IdProvider as TIds
from chip_smoke import same_values
from test_torch_estimator import jax_rig, port_imu, port_rig, snapshot
from test_torch_frontend import KeyReplay, jax_frame, port_frame, replay_draws
from test_torch_vio_loop import assert_same_vio_window

torch.set_num_threads(2)
NS = 1_000_000_000
N_FRAMES, K_SEQ, CKPT_AFTER = 9, 64, 5
TOL = 1e-8
TOL_LANDMARK = 5e-8
IMG = np.zeros((480, 752), np.float32)


class Harness:
    """A ThreadedVio of either package, with the dataflow counted and every
    output recorded; given keypoint frames, behind a stub detector that
    hands it the next one (made by make_frame)."""

    def __init__(self, vio, frames=None, make_frame=None, start=0):
        self.vio, self.next = vio, start
        self.mfs, self.published, self.transferred, self.imu_i = [], [], [], 0
        self.counts = dict(detect=0, assoc=0, opt=0, marg=0)
        self.snapshots = []
        fe, est = vio.frontend, vio.estimator

        def detect(images, T_WS=None):
            self.counts["detect"] += 1
            f = frames[self.next]
            self.next += 1
            K = f.uv.shape[1]
            fds = [make_frame(f.uv[c], f.mask[c], f.descriptors[c], np.zeros(K, np.int64), K)
                   for c in range(len(images))]
            self.mfs.append(fds)
            return fds

        def counted(name, fn):
            def wrapper(*a, **k):
                self.counts[name] += 1
                return fn(*a, **k)
            return wrapper

        if frames is not None:
            fe.detect_and_describe_multi = detect
        fe.data_association_and_initialization = counted("assoc", fe.data_association_and_initialization)
        est.optimize = counted("opt", est.optimize)
        est.apply_marginalization_strategy = counted("marg", est.apply_marginalization_strategy)

    def record_callbacks(self):
        self.vio.propagated_state_callback = lambda t, T, sb: self.published.append(
            (t, np.asarray(T.r, np.float64), np.asarray(T.q, np.float64), np.array(sb, np.float64)))
        self.vio.transferred_landmarks_callback = lambda t, lms: self.transferred.append(
            (t, sorted(lms), {i: np.asarray(hp) for i, hp in lms.items()}))

    def feed(self, traj, fi, imu_from_ns=None, images=(IMG, IMG)):
        """Frame fi: the IMU up to 25 ms past it (from imu_from_ns, else from
        where the last frame's stopped), a position measurement, the images,
        wait_idle; then a snapshot of the window."""
        t_ns = int(fi * 0.1 * NS)
        ts_ns = (traj.ts * NS).astype(np.int64)
        i = self.imu_i if imu_from_ns is None else int(np.searchsorted(ts_ns, imu_from_ns))
        while i < len(ts_ns) and ts_ns[i] <= t_ns + 25_000_000:
            self.vio.add_imu_measurement(int(ts_ns[i]), traj.gyro[i], traj.acc[i])
            i += 1
        self.imu_i = i
        self.vio.add_position_measurement(t_ns, np.asarray([1.0, 2.0, 3.0]) * fi)
        for c, image in enumerate(images):
            self.vio.add_image(t_ns, c, image)
        self.vio.wait_idle(timeout=120)
        self.snapshots.append(snapshot(self.vio.estimator, []))


def _next_id() -> int:
    """The port's next id, left unconsumed."""
    n = TIds.new_id()
    TIds.reset()
    TIds.advance_past(n - 1)
    return n


def jax_params():
    p = JVioParameters()
    p.optimization.max_num_keypoints = K_SEQ
    return p


def port_params():
    p = VioParameters()
    p.optimization.max_num_keypoints = K_SEQ
    return p


def _csv_files(vio, d):
    vio.set_imu_csv_file(str(d / "imu.csv"))
    vio.set_pos_csv_file(str(d / "pos.csv"))
    vio.set_mag_csv_file(str(d / "mag.csv"))
    vio.set_state_csv_file(str(d / "state.csv"))
    for c in range(2):
        vio.set_tracks_csv_file(c, str(d / f"tracks{c}.csv"))


def _rigs():
    jrig, trig = jax_rig(), port_rig()
    jrig.compute_overlaps()
    trig.compute_overlaps()
    assert np.array_equal(jrig.overlaps, trig.overlaps)
    return jrig, trig


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    traj = simulate_trajectory(duration=1.2, seed=31, motion_scale=0.25)
    lms = make_landmarks(traj, 600, seed=32, radius=(4.0, 8.0))
    frames = keypoint_frames(traj, lms, port_rig(), N_FRAMES, K_SEQ, seed=3)
    jrig, trig = _rigs()
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("jax", "port", "ckpt")}

    JIds.reset()
    jvio = JThreadedVio(jax_params(), rig=jrig, blocking=True, dtype=jnp.float64)
    jax_h = Harness(jvio, frames, jax_frame)
    _csv_files(jvio, dirs["jax"])
    jax_h.record_callbacks()

    TIds.reset()
    tvio = ThreadedVio(port_params(), rig=trig, blocking=True, dtype=torch.float64, device="cpu")
    port_h = Harness(tvio, frames, port_frame)
    _csv_files(tvio, dirs["port"])
    port_h.record_callbacks()
    keys = replay_draws(jvio.frontend, tvio.frontend)

    for fi in range(N_FRAMES):
        jax_h.feed(traj, fi)
    jvio.shutdown()
    ckpt = None
    for fi in range(N_FRAMES):
        port_h.feed(traj, fi)
        if fi + 1 == CKPT_AFTER:
            path = str(dirs["ckpt"] / "vio.ckpt")
            tvio.save_checkpoint(path)
            ckpt = dict(path=path, window=convert.estimator_to_numpy(tvio.estimator), draws=tvio.frontend._draw.pos,
                        ids=_next_id())
    tvio.shutdown()
    return dict(jax=jax_h, port=port_h, traj=traj, frames=frames, keys=keys, dirs=dirs, ckpt=ckpt, trig=trig)


def test_states_match_jax(run):
    jt, tt = run["jax"].vio.trajectory, run["port"].vio.trajectory
    assert len(tt) == len(jt) == N_FRAMES
    for i, (a, b) in enumerate(zip(tt, jt)):
        assert (a.timestamp_ns, a.is_keyframe) == (b.timestamp_ns, b.is_keyframe), i
        np.testing.assert_allclose(a.T_WS.r.numpy(), np.asarray(b.T_WS.r), rtol=0, atol=TOL, err_msg=str(i))
        np.testing.assert_allclose(a.T_WS.q.numpy(), np.asarray(b.T_WS.q), rtol=0, atol=TOL, err_msg=str(i))
        np.testing.assert_allclose(a.speed_and_bias, b.speed_and_bias, rtol=0, atol=TOL, err_msg=str(i))
    assert tt[0].is_keyframe and run["port"].vio.frontend.is_initialized


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_window_and_keypoint_landmarks_match_jax_after_frame(run, frame):
    what = f"frame {frame + 1}"
    for a, b in zip(run["port"].mfs[frame], run["jax"].mfs[frame]):
        np.testing.assert_array_equal(a.landmark_ids, b.landmark_ids, err_msg=what)
    assert_same_vio_window(run["port"].snapshots[frame], run["jax"].snapshots[frame], what, TOL_LANDMARK)


def test_propagated_states_and_transferred_landmarks_match_jax(run):
    got, want = run["port"].published, run["jax"].published
    assert len(got) == len(want) > 100
    # publishing starts after the first optimized state
    assert got[0][0] > run["port"].vio.trajectory[0].timestamp_ns
    for (ta, *a), (tb, *b) in zip(got, want):
        assert ta == tb
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=0, atol=TOL, err_msg=str(ta))
    got, want = run["port"].transferred, run["jax"].transferred
    assert [g[:2] for g in got] == [w[:2] for w in want] and sum(len(g[1]) for g in got) > 0
    for g, w in zip(got, want):
        for i in g[1]:
            np.testing.assert_allclose(g[2][i], w[2][i], rtol=0, atol=1e-7)


def test_dataflow_one_call_per_frame(run):
    """tests/test_pipeline.py:303's counts: one detection batch,
    association, optimize and marginalization per frame."""
    for h in (run["port"], run["jax"]):
        assert h.counts == dict(detect=N_FRAMES, assoc=N_FRAMES, opt=N_FRAMES, marg=N_FRAMES)


@pytest.mark.parametrize("name", ["imu.csv", "pos.csv", "mag.csv", "tracks0.csv", "tracks1.csv"])
def test_csv_files_equal_jax_byte_for_byte(run, name):
    got = (run["dirs"]["port"] / name).read_bytes()
    assert got == (run["dirs"]["jax"] / name).read_bytes()
    assert len(got.splitlines()) > (1 if name != "mag.csv" else 0)


def test_state_csv_has_a_row_per_state(run):
    rows = (run["dirs"]["port"] / "state.csv").read_text().splitlines()
    assert rows[0].startswith("#timestamp_ns") and len(rows) == 1 + N_FRAMES
    want = (run["dirs"]["jax"] / "state.csv").read_text().splitlines()
    for a, b in zip(rows[1:], want[1:]):
        np.testing.assert_allclose(np.array(a.split(","), float), np.array(b.split(","), float), rtol=0, atol=TOL)


def test_checkpoint_restores_the_window_and_resumes_equal(run):
    """Save after the fifth frame, load into a fresh ThreadedVio: the same window
    exactly; fed the IMU again from half a second before the checkpoint's
    last state and the last 4 frames with the same RANSAC draws, it
    continues equal to the uninterrupted run."""
    ck = run["ckpt"]
    vio = ThreadedVio(port_params(), rig=run["trig"], blocking=True, dtype=torch.float64, device="cpu")
    TIds.reset()
    vio.load_checkpoint(ck["path"])
    got = convert.estimator_to_numpy(vio.estimator)
    assert got.keys() == ck["window"].keys()
    for k, v in ck["window"].items():
        assert same_values(got[k], v), k
    assert vio.estimator.marg_valid and isinstance(vio.estimator.marg_H, torch.Tensor)
    # fresh ids continue past every restored one
    est = vio.estimator
    restored = [*est.states, *est.landmarks,
                *(int(fd.landmark_ids.max()) for mf in est.multiframes.values() for fd in mf.frames)]
    assert len(est.multiframes) == len(est.states) and max(restored) < _next_id() <= ck["ids"]

    TIds.reset()
    TIds.advance_past(ck["ids"] - 1)  # the uninterrupted run's next id
    h = Harness(vio, run["frames"], port_frame, start=CKPT_AFTER)
    vio.frontend._draw = KeyReplay(run["keys"], start=ck["draws"])
    t_last = int((CKPT_AFTER - 1) * 0.1 * NS)
    for fi in range(CKPT_AFTER, N_FRAMES):
        h.feed(run["traj"], fi, imu_from_ns=t_last - NS // 2 if fi == CKPT_AFTER else None)
    vio.shutdown()
    for i, fi in enumerate(range(CKPT_AFTER, N_FRAMES)):
        a, b = vio.trajectory[i], run["port"].vio.trajectory[fi]
        assert (a.timestamp_ns, a.is_keyframe) == (b.timestamp_ns, b.is_keyframe)
        for x, y in ((a.T_WS.r, b.T_WS.r), (a.T_WS.q, b.T_WS.q), (a.speed_and_bias, b.speed_and_bias)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=TOL, err_msg=str(fi))
        for x, y in zip(h.mfs[i], run["port"].mfs[fi]):
            np.testing.assert_array_equal(x.landmark_ids, y.landmark_ids)
        assert_same_vio_window(h.snapshots[i], run["port"].snapshots[fi], f"resumed frame {fi + 1}")


def test_estimator_checkpoint_round_trip(tmp_path):
    """tests/test_estimator.py:255: one state, one landmark and one
    observation through save_checkpoint / load_checkpoint."""
    from okvis_tpu_torch.estimator import Estimator

    est = Estimator(port_rig(), port_imu(), device="cpu")
    n = 20
    ts = np.arange(n) / 200.0
    sid = est.add_states(ts[-1], ts, np.zeros((n, 3)), np.tile([0, 0, 9.81], (n, 1)), True)
    est.add_landmark(42, np.asarray([1.0, 2.0, 3.0]))
    est.add_observation(42, sid, 0, np.asarray([100.0, 200.0]))
    path = str(tmp_path / "ckpt.pkl")
    est.save_checkpoint(path)

    est2 = Estimator(port_rig(), port_imu(), device="cpu")
    est2.load_checkpoint(path)
    assert est2.num_frames() == 1 and est2.num_landmarks() == 1
    np.testing.assert_allclose(est2.get_T_WS(sid).q.numpy(), est.get_T_WS(sid).q.numpy())
    np.testing.assert_allclose(est2.get_landmark(42), est.get_landmark(42))
    assert len(est2.observations) == 1 and len(est2.pose_priors) == 1
    assert same_values(convert.estimator_to_numpy(est2), convert.estimator_to_numpy(est))


def test_checkpoint_refuses_a_foreign_file(tmp_path):
    import pickle

    from okvis_tpu_torch.estimator import Estimator

    path = tmp_path / "other.pkl"
    path.write_bytes(pickle.dumps(dict(states={})))
    with pytest.raises(ValueError, match="not a checkpoint"):
        Estimator(port_rig(), port_imu(), device="cpu").load_checkpoint(str(path))


def test_window_parameters_are_the_estimators(run):
    """Both runtimes built the same default window from VioParameters."""
    jcfg, tcfg = run["jax"].vio.estimator.cfg, run["port"].vio.estimator.cfg
    assert convert.window_config_from_dict(dataclasses.asdict(jcfg)) == tcfg
