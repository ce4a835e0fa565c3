"""The port's EuRoC path against the JAX package's, on the CPU: the
dataset writer, the loader and its decoders, the app's feed and outputs,
the sweep, the textured-plane renderer, and one real small-rig run of each
app.

Tolerances:
- write_euroc_format: the same file names, byte-equal CSVs; the PNG pixels
  of the two writers differ by at most one grey level, at no more than
  0.05 % of the pixels (measured: none of 7,219,200). The renderers agree to
  1e-3 (tests/test_torch_stereo_slice.py), so a value next to an integer
  can truncate to either side of it;
- the loaders: IMU samples, image events, measurement order, ground truth
  and the skip_sec cut exactly; the images of each port decoder exactly
  equal to the JAX loader's (PIL, the JAX native decoder kept off so this
  test never builds into okvis_tpu/native/build/);
- run with ThreadedVio swapped for a recorder: the same calls in the same
  order with exactly equal arrays, the same outputs and byte-equal .tum and
  .loop files;
- the sweeps' summaries exactly equal, with run stubbed;
- render_textured_plane: 1e-3 grey levels (both back-project in float64);
- the real runs (376 x 240 rig, 8 frames, float64, a YAML the test
  writes): the same frames processed and pose-graph keyframes, each ATE
  under 0.2 m, and the two ATEs within 1e-4 m of each other (measured:
  2e-8 m).
"""

import dataclasses
import json
import os
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import okvis_tpu.datasets.euroc as jeuroc
from okvis_tpu import kinematics as jkin
from okvis_tpu.apps import euroc_sweep as jsweep
from okvis_tpu.apps import run_euroc as jrun
from okvis_tpu.cameras import NCameraSystem as JNCameraSystem
from okvis_tpu.datasets import synthetic as jsyn
from okvis_tpu_torch import kinematics as tkin
from okvis_tpu_torch.apps import euroc_sweep as tsweep
from okvis_tpu_torch.apps import run_euroc as trun
from okvis_tpu_torch.cameras.ncamera import NCameraSystem
from okvis_tpu_torch.config import VioParameters
from okvis_tpu_torch.config.yaml_writer import cameras_from_rig, write_config
from okvis_tpu_torch.convert import rig_from_numpy
from okvis_tpu_torch.datasets import euroc as teuroc
from okvis_tpu_torch.datasets import synthetic as tsyn

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _jax_loader_reads_with_pil():
    """The JAX loader's native decoder would build into the JAX package's
    own okvis_tpu/native/build/; keep it off, so it reads with PIL."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeuroc, "_native_decode", False)
        yield


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """tests/test_euroc_app.py's world (1.5 s, seed 41, 240 landmarks at
    4-8 m, 10 frames) written by each package's write_euroc_format."""
    out = tmp_path_factory.mktemp("euroc")
    jspecs, jT, jintr = jsyn.euroc_stereo_rig()
    jrig = JNCameraSystem(specs=tuple(jspecs), T_SC=jT, intrinsics=jintr)
    specs, T_SC, intr = tsyn.euroc_stereo_rig(device="cpu")
    trig = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)
    jtraj = jsyn.simulate_trajectory(duration=1.5, seed=41, motion_scale=0.25)
    ttraj = tsyn.simulate_trajectory(duration=1.5, seed=41, motion_scale=0.25)
    lms = tsyn.make_landmarks(ttraj, 240, seed=42, radius=(4.0, 8.0))
    jmav0 = jsyn.write_euroc_format(str(out / "jax"), jtraj, jsyn.make_landmarks(jtraj, 240, seed=42, radius=(4.0, 8.0)),
                                    jrig, frame_dt=0.1, n_frames=10)
    tmav0 = tsyn.write_euroc_format(str(out / "torch"), ttraj, lms, trig, frame_dt=0.1, n_frames=10)
    params = VioParameters()
    params.cameras = cameras_from_rig(trig)
    yaml_path = str(out / "config.yaml")
    write_config(params, yaml_path)
    return SimpleNamespace(jmav0=jmav0, tmav0=tmav0, traj=ttraj, trig=trig, params=params, yaml=yaml_path,
                           root=out)


def _files(mav0):
    return sorted(os.path.relpath(os.path.join(d, f), mav0) for d, _, fs in os.walk(mav0) for f in fs)


def test_writers_give_the_same_files(worlds):
    from PIL import Image

    names = _files(worlds.tmav0)
    assert names == _files(worlds.jmav0)
    assert len([n for n in names if n.endswith(".png")]) == 20
    differ, total = 0, 0
    for n in names:
        a, b = os.path.join(worlds.tmav0, n), os.path.join(worlds.jmav0, n)
        if n.endswith(".csv"):
            assert open(a, "rb").read() == open(b, "rb").read(), n
            continue
        ta = np.asarray(Image.open(a), np.int16)
        tb = np.asarray(Image.open(b), np.int16)
        assert ta.shape == tb.shape == (480, 752)
        assert np.abs(ta - tb).max() <= 1, n
        differ += int((ta != tb).sum())
        total += ta.size
    print(f"pixels one grey level apart: {differ} of {total}")
    assert differ <= 5e-4 * total


def _event(e):
    return (e.timestamp_ns, e.cam_idx, os.path.basename(e.path), e.width, e.height)


@pytest.mark.parametrize("which", ["tmav0", "jmav0"])
@pytest.mark.parametrize("skip_sec", [0.0, 0.35])
def test_loaders_equal(worlds, which, skip_sec):
    mav0 = getattr(worlds, which)
    j = jeuroc.EurocDataset(mav0, num_cameras=2, skip_sec=skip_sec)
    t = teuroc.EurocDataset(mav0, num_cameras=2, skip_sec=skip_sec)
    assert len(t.imu) == len(j.imu) == len(worlds.traj.ts)
    for a, b in zip(t.imu, j.imu):
        assert a.timestamp_ns == b.timestamp_ns
        np.testing.assert_array_equal(a.gyro, b.gyro)
        np.testing.assert_array_equal(a.acc, b.acc)
    assert [_event(e) for e in t.images] == [_event(e) for e in j.images]
    assert len(t.images) == (20 if skip_sec == 0 else 12)
    order = lambda ms: [(type(m).__name__, m.timestamp_ns, getattr(m, "cam_idx", -1)) for m in ms]  # noqa: E731
    assert order(t.measurements()) == order(j.measurements())
    for a, b in zip(t.imu_arrays(), j.imu_arrays()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.ground_truth(), j.ground_truth()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.ground_truth()[2][5], worlds.traj.q[5])  # wxyz in the file, xyzw here


@pytest.mark.parametrize("decoder", ["python", "native", "auto"])
@pytest.mark.parametrize("which", ["tmav0", "jmav0"])
def test_each_decoder_equals_the_jax_loader(worlds, which, decoder):
    from okvis_tpu_torch import native

    mav0 = getattr(worlds, which)
    if decoder == "native":
        try:
            native.get_lib()
        except native.NativeUnavailable as e:
            pytest.skip(f"no native toolchain: {e}")
    j = jeuroc.EurocDataset(mav0, num_cameras=2)
    t = teuroc.EurocDataset(mav0, num_cameras=2, decoder=decoder)
    for a, b in zip(t.images[::5], j.images[::5]):
        img = a.load()
        assert img.dtype == np.float32 and img.shape == (480, 752)
        np.testing.assert_array_equal(img, b.load())
    used = set(t.decoder_used.values())
    assert len(t.decoder_used) == 4
    assert used == ({"python"} if decoder == "python" else {"native"} if decoder == "native"
                    else {"native"} if teuroc._get_native_decode() else {"python"})


def test_decoders_on_another_size(tmp_path):
    """auto falls back to png.py on an image of another size (the JAX loader
    to PIL); native refuses it; an unknown decoder is refused."""
    from okvis_tpu_torch.datasets.png import write_png_gray

    img = np.random.default_rng(1).integers(0, 256, (240, 376), dtype=np.uint8)
    path = str(tmp_path / "1000.png")
    write_png_gray(path, img)
    log = {}
    ev = teuroc.ImageEvent(1000, 0, path, decoder="auto", log=log)
    np.testing.assert_array_equal(ev.load(), img)
    assert log == {path: "python"}
    np.testing.assert_array_equal(jeuroc.ImageEvent(1000, 0, path).load(), img)
    if teuroc._get_native_decode():
        with pytest.raises(IOError):
            teuroc.ImageEvent(1000, 0, path, decoder="native").load()
    with pytest.raises(ValueError, match="decoder"):
        teuroc.EurocDataset(str(tmp_path), decoder="pil")


# ---------------------------------------------------------------------------
# the app's feed and outputs, with ThreadedVio swapped for a recorder
# ---------------------------------------------------------------------------


def _plain(tree):
    def conv(x):
        if isinstance(x, np.ndarray):
            return ("array", x.shape, x.tolist())
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return x
    return conv(dataclasses.asdict(tree))


def _recorder(calls: list):
    """A stand-in for either package's ThreadedVio that records every call;
    each camera-0 image adds a state to its trajectory (a position from the
    timestamp), and with the pose graph on every other state is a pose-graph
    keyframe and two loop events exist, one accepted."""

    class Recorder:
        def __init__(self, params, rig=None, blocking=True, dtype=None, device=None):
            calls.append(("init", _plain(params), rig is None, blocking))
            self.trajectory, self.full_state_callback = [], None
            self.posegraph = None
            if params.posegraph.enabled:
                self.posegraph = SimpleNamespace(
                    trajectory=lambda: [(i, s.timestamp_ns, s.T_WS.r.numpy(), s.T_WS.q.numpy())
                                        for i, s in enumerate(self.trajectory) if i % 2 == 0],
                    loop_events=[SimpleNamespace(accepted=True), SimpleNamespace(accepted=False)])

        def add_imu_measurement(self, ts, gyro, acc):
            calls.append(("imu", ts, np.asarray(gyro).tolist(), np.asarray(acc).tolist()))

        def add_image(self, ts, cam, image):
            calls.append(("image", ts, cam, image.dtype.str, image.shape, float(image.sum()),
                          float((image * np.arange(image.shape[1])).sum())))
            if cam == 0:
                x = (ts % 10**10) * 1e-10
                self.trajectory.append(SimpleNamespace(
                    timestamp_ns=ts, speed_and_bias=np.full(9, x),
                    T_WS=SimpleNamespace(r=torch.tensor([x, 0.5 * x * x, -0.2], dtype=torch.float64),
                                         q=torch.tensor([0.0, 0.0, np.sin(x), np.cos(x)], dtype=torch.float64))))

        def wait_idle(self, timeout=60.0):
            calls.append(("wait_idle", timeout))

        def save_checkpoint(self, path):
            calls.append(("save_checkpoint", os.path.basename(path)))

        def load_checkpoint(self, path):
            calls.append(("load_checkpoint", os.path.basename(path)))

        def shutdown(self):
            calls.append(("shutdown",))
            if self.full_state_callback is not None:
                for s in self.trajectory:
                    self.full_state_callback(s.timestamp_ns, s.T_WS, s.speed_and_bias)
            return "timing table"

    return Recorder


@pytest.mark.parametrize("case", [
    dict(),
    dict(max_frames=4),
    dict(loop_closure=True, skip_sec=0.3, detection_threshold=15.0, max_keypoints=200),
    dict(loop_closure=True, checkpoint_out="run.ckpt", resume="old.ckpt", pose_view="view.png", max_frames=7),
])
def test_run_feeds_and_reports_as_jax(worlds, tmp_path, monkeypatch, case):
    got = {}
    for name, mod, kw in (("jax", jrun, dict(dtype=jnp.float64)),
                          ("torch", trun, dict(dtype=torch.float64, device="cpu"))):
        calls = []
        monkeypatch.setattr(mod, "ThreadedVio", _recorder(calls))
        d = tmp_path / name
        d.mkdir()
        case_kw = {k: str(d / v) if k in ("checkpoint_out", "resume", "pose_view") else v for k, v in case.items()}
        out = mod.run(worlds.yaml, worlds.tmav0, trajectory_out=str(d / "traj.tum"), **kw, **case_kw)
        got[name] = (calls, out, d)
    (jcalls, jout, jd), (tcalls, tout, td) = got["jax"], got["torch"]
    assert tcalls == jcalls
    n = case.get("max_frames", 0) or 10 - 3 * ("skip_sec" in case)
    assert tout["frames_fed"] == jout["frames_fed"] == n
    images = [i for i, c in enumerate(tcalls) if c[0] == "image"]
    if case.get("max_frames"):
        # the feed breaks right after camera 0's image of the last frame:
        # its camera-1 image and the IMU after it are never fed
        assert tcalls[images[-1]][2] == 0 and tcalls[images[-1] + 1][0] == "wait_idle"
        assert len(images) == 2 * n - 1
    else:
        assert len(images) == 2 * n
    native = "native" if teuroc._get_native_decode() else "python"
    assert tout.pop("decoder_used") == {native: len(images)}
    for k in ("wall_s", "frames_per_s"):
        assert tout.pop(k) >= 0 and jout.pop(k) >= 0
    assert tout == jout
    if case.get("loop_closure"):
        assert tout["loop_closures"] == 1 and tout["posegraph_keyframes"] >= 2
    for f in _files(str(jd)):
        if f.endswith(".png"):
            from PIL import Image

            np.testing.assert_array_equal(np.asarray(Image.open(td / f)), np.asarray(Image.open(jd / f)))
        else:
            assert (td / f).read_bytes() == (jd / f).read_bytes(), f
    assert _files(str(td)) == _files(str(jd))
    assert ("traj.tum.loop" in _files(str(td))) == bool(case.get("loop_closure"))


def test_run_accepts_parameters_built_in_code(worlds, tmp_path, monkeypatch):
    """config may be a VioParameters (the card machine has no PyYAML): the
    same calls as from its YAML, and the caller's tree is left unchanged."""
    runs = []
    for config in (worlds.yaml, worlds.params):
        calls = []
        monkeypatch.setattr(trun, "ThreadedVio", _recorder(calls))
        trun.run(config, worlds.tmav0, max_frames=3, trajectory_out=str(tmp_path / "t.tum"), device="cpu",
                 loop_closure=True, max_keypoints=100)
        runs.append(calls)
    assert runs[0] == runs[1]
    assert worlds.params.posegraph.enabled is False and worlds.params.optimization.max_num_keypoints == 400


def test_run_refuses_missing_inputs(worlds, tmp_path):
    with pytest.raises(SystemExit, match="dataset directory not found"):
        trun.run(worlds.yaml, str(tmp_path / "nothing"), device="cpu")
    with pytest.raises(SystemExit, match="config file not found"):
        trun.run(str(tmp_path / "none.yaml"), worlds.tmav0, device="cpu")


def test_distributed_raises_the_item_8_error(worlds, tmp_path, capsys):
    """The distributed mode is ported (it raised before): run_euroc
    --distributed 2 on the CPU, the BA sharded over a 2-shard CPU mesh,
    runs to the end with every frame processed."""
    trun.main([worlds.yaml, worlds.tmav0, "--distributed", "2", "--device", "cpu",
               "--trajectory-out", str(tmp_path / "t.tum")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames_processed"] == out["frames_fed"] == 10
    assert out["ate_rmse_m"] is not None and out["ate_rmse_m"] < 0.2
    assert len(open(tmp_path / "t.tum").read().splitlines()) == 10


def test_sweeps_give_the_same_summary(worlds, tmp_path, monkeypatch):
    root = tmp_path / "euroc_root"
    (root / "MH_01_easy").mkdir(parents=True)
    shutil.copytree(worlds.tmav0, root / "MH_01_easy" / "mav0")
    (root / "V1_02_medium").mkdir()  # present but empty: missing
    summaries, seen = {}, {}
    for name, run_mod, sweep_mod in (("jax", jrun, jsweep), ("torch", trun, tsweep)):
        calls = seen.setdefault(name, [])

        def fake_run(config, mav0, calls=calls, **kw):
            calls.append((config, os.path.relpath(mav0, root), {k: v for k, v in kw.items() if k != "device"}))
            if "V2" in mav0:
                raise RuntimeError("bad sequence")
            return dict(ate_rmse_m=0.0125, frames_per_s=3.5, frames_processed=10)

        monkeypatch.setattr(run_mod, "run", fake_run)
        summaries[name] = sweep_mod.sweep(worlds.yaml, str(root), sequences=("MH_01_easy", "V1_02_medium"),
                                          out_dir=str(tmp_path / "out"), max_frames=5, loop_closure=True)
    assert summaries["torch"] == summaries["jax"]
    assert seen["torch"] == seen["jax"]
    s = summaries["torch"]
    assert s["n_ok"] == 1 and s["n_missing"] == 1 and s["ate_mean_m"] == s["ate_median_m"] == 0.0125
    assert tsweep.EUROC_SEQUENCES == jsweep.EUROC_SEQUENCES and len(tsweep.EUROC_SEQUENCES) == 11
    (root / "V2_01_easy" / "cam0").mkdir(parents=True)  # mav0-shaped: found, and its error reported
    for mod in (jsweep, tsweep):
        out = mod.sweep(worlds.yaml, str(root), sequences=("V2_01_easy",))
        assert out["sequences"]["V2_01_easy"]["status"] == "error" and out["n_ok"] == 0


def test_sweep_main_writes_its_summary(worlds, tmp_path, monkeypatch):
    monkeypatch.setattr(trun, "run", lambda *a, **kw: dict(ate_rmse_m=None, frames_per_s=1.0, frames_processed=1))
    (tmp_path / "root" / "MH_01_easy" / "mav0").mkdir(parents=True)
    out = tmp_path / "sweep.json"
    summary = tsweep.main([worlds.yaml, str(tmp_path / "root"), "--sequences", "MH_01_easy, V2_03_difficult",
                           "--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == summary
    assert summary["n_ok"] == 1 and summary["ate_mean_m"] is None


# ---------------------------------------------------------------------------
# render_textured_plane
# ---------------------------------------------------------------------------


def _plane_distance(spec, intr, T_WC) -> np.ndarray:
    """(H, W) distance along each pixel's unit-z ray to the plane z = 0 (inf
    where it misses)."""
    from okvis_tpu_torch.cameras import pinhole

    us, vs = np.meshgrid(np.arange(spec.width, dtype=np.float64), np.arange(spec.height, dtype=np.float64))
    rays = pinhole.back_project(spec, intr, torch.from_numpy(np.stack([us, vs], -1))).numpy()
    dz = rays @ tkin.quat_to_matrix(T_WC.q).numpy()[2]
    t = -T_WC.r[2].item() / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
    return np.where(t > 0.05, t, np.inf)


@pytest.mark.parametrize("pose", [
    ([0.1, -0.2, 3.0], [1.0, 0.0, 0.0, 0.0]),  # looking straight down from 3 m
    ([0.3, 0.4, 1.5], [0.8191520443, 0.0, 0.0, 0.5735764364]),  # tilted 70° off the vertical: sky above
])
def test_render_textured_plane_matches_jax(pose):
    specs, T_SC, intr = jsyn.euroc_stereo_rig()
    jrig = JNCameraSystem(specs=tuple(specs), T_SC=T_SC, intrinsics=intr)
    tspecs, tT, tintr = tsyn.euroc_stereo_rig(device="cpu")
    trig = NCameraSystem(specs=tspecs, T_SC=tT, intrinsics=tintr)
    tex = tsyn.noise_texture(256, seed=3)
    r, q = pose
    for cam in range(2):
        jT = jkin.compose(jkin.SE3(r=jnp.asarray(r), q=jnp.asarray(q)), jrig.camera_T_SC(cam))
        tT_ = tkin.compose(tkin.SE3(r=torch.tensor(r, dtype=torch.float64), q=torch.tensor(q, dtype=torch.float64)),
                           trig.camera_T_SC(cam))
        a = tsyn.render_textured_plane(tspecs[cam], tintr[cam], tT_, tex, plane_scale=150.0)
        b = jsyn.render_textured_plane(specs[cam], intr[cam], jT, tex, plane_scale=150.0)
        assert a.dtype == np.float32 and a.shape == (480, 752)
        # where the ray meets the plane within 100 m; beyond, at grazing rays
        # near the horizon, a 1e-14 difference in the back-projected ray
        # moves the sample by a texture pixel (the hit test still agrees)
        near = _plane_distance(tspecs[cam], tintr[cam], tT_) < 100.0
        np.testing.assert_allclose(a[near], b[near], rtol=0, atol=1e-3)
        np.testing.assert_array_equal(a == 90.0, b == 90.0)
        sky = a == 90.0
        if r[2] < 2:
            assert 0.05 < sky.mean() < 0.95  # rays that miss the plane, and rays that hit it
        else:
            assert not sky.any()


def test_noise_texture():
    a, b = tsyn.noise_texture(128, seed=5), tsyn.noise_texture(128, seed=5)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32 and 0 <= a.min() and a.max() <= 255 and 120 < a.mean() < 136 and a.std() > 35
    assert not np.array_equal(a, tsyn.noise_texture(128, seed=6))


# ---------------------------------------------------------------------------
# one real run of each app, small rig
# ---------------------------------------------------------------------------


def test_small_rig_app_runs_agree(tmp_path):
    """Both apps on the same 376 x 240 dataset (the port's writer), the
    same YAML, float64 on the CPU, with loop closure on."""
    _, T_SC, intr = tsyn.euroc_stereo_rig(device="cpu")
    half = intr[0].numpy().copy()
    half[:4] *= 0.5
    rig = rig_from_numpy([(376, 240, "radtan")] * 2, T_SC.r.numpy(), T_SC.q.numpy(), [half, half], device="cpu")
    traj = tsyn.simulate_trajectory(duration=1.5, seed=41, motion_scale=0.25)
    lms = tsyn.make_landmarks(traj, 240, seed=42, radius=(4.0, 8.0))
    mav0 = tsyn.write_euroc_format(str(tmp_path / "ds"), traj, lms, rig, frame_dt=0.1, n_frames=8)
    p = VioParameters()
    p.cameras = cameras_from_rig(rig)
    p.optimization.detection_threshold = 15.0
    p.optimization.max_num_keypoints = 200
    write_config(p, str(tmp_path / "small.yaml"))
    kw = dict(loop_closure=True)
    t = trun.run(str(tmp_path / "small.yaml"), mav0, dtype=torch.float64, device="cpu",
                 trajectory_out=str(tmp_path / "t.tum"), **kw)
    j = jrun.run(str(tmp_path / "small.yaml"), mav0, dtype=jnp.float64, trajectory_out=str(tmp_path / "j.tum"), **kw)
    print({k: (t[k], j[k]) for k in j if k != "timing"})
    assert t["frames_processed"] == j["frames_processed"] == t["frames_fed"] == 8
    assert t["posegraph_keyframes"] == j["posegraph_keyframes"] >= 2
    assert t["loop_closures"] == j["loop_closures"] == 0
    assert t["decoder_used"] == {"python": 16}  # auto: the native loader refuses 376 x 240
    assert t["ate_rmse_m"] < 0.2 and j["ate_rmse_m"] < 0.2
    assert abs(t["ate_rmse_m"] - j["ate_rmse_m"]) < 1e-4
    assert abs(t["ate_rmse_loop_m"] - j["ate_rmse_loop_m"]) < 1e-4
