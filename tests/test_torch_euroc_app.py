"""Slow analogs of the JAX package's EuRoC app tests for the port
(tests/test_euroc_app.py's CLI run, sweep and checkpoint/resume, and
tests/test_posegraph.py::TestPipelineIntegration), on the CPU in float64.

The world is tests/test_euroc_app.py's (1.5 s, seed 41, 240 landmarks at
4-8 m, 10 frames at 0.1 s), written by the port's write_euroc_format. The
JAX tests read the stock reference YAML, which is not in the repository;
these write their own: the EuRoC defaults (VioParameters) with the
synthetic rig's cameras, threshold 15 and 200 keypoints (the JAX tests'
overrides). Bounds are the JAX tests' own.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from okvis_tpu_torch.apps.euroc_sweep import EUROC_SEQUENCES, sweep
from okvis_tpu_torch.apps.run_euroc import main, run
from okvis_tpu_torch.cameras.ncamera import NCameraSystem
from okvis_tpu_torch.config import VioParameters
from okvis_tpu_torch.config.yaml_writer import cameras_from_rig, write_config
from okvis_tpu_torch.datasets.euroc import EurocDataset
from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, make_landmarks, simulate_trajectory, write_euroc_format

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def synthetic_euroc(tmp_path_factory):
    out = tmp_path_factory.mktemp("euroc")
    traj = simulate_trajectory(duration=1.5, seed=41, motion_scale=0.25)
    specs, T_SC, intrinsics = euroc_stereo_rig(device="cpu")
    rig = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intrinsics)
    lms = make_landmarks(traj, 240, seed=42, radius=(4.0, 8.0))
    mav0 = write_euroc_format(str(out), traj, lms, rig, frame_dt=0.1, n_frames=10)
    params = VioParameters()
    params.cameras = cameras_from_rig(rig)
    params.optimization.detection_threshold = 15.0
    params.optimization.max_num_keypoints = 200
    config = str(out / "config.yaml")
    write_config(params, config)
    return mav0, traj, rig, config


def test_euroc_loader_full_size(synthetic_euroc):
    mav0, traj, _, _ = synthetic_euroc
    ds = EurocDataset(mav0, num_cameras=2)
    assert len(ds.imu) == len(traj.ts) and len(ds.images) == 20
    ts = [m.timestamp_ns for m in ds.measurements()]
    assert ts == sorted(ts)
    assert ds.images[0].load().shape == (480, 752)
    gt_ts, gt_p, gt_q = ds.ground_truth()
    np.testing.assert_allclose(gt_p[0], traj.r[0], atol=1e-9)
    np.testing.assert_allclose(gt_q[5], traj.q[5], atol=1e-9)


def test_run_euroc_app_cli(synthetic_euroc, tmp_path, capsys):
    """The CLI end to end: config + dataset -> trajectory + ATE (one JSON
    line on stdout, the timing table on stderr)."""
    mav0, _, _, config = synthetic_euroc
    main([config, mav0, "--f64", "--device", "cpu", "--trajectory-out", str(tmp_path / "traj.tum")])
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert out["frames_processed"] >= 6
    assert out["ate_rmse_m"] is not None and out["ate_rmse_m"] < 0.2, out
    assert os.path.exists(tmp_path / "traj.tum")
    assert "detectAndDescribe" in captured.err


def test_euroc_sweep(synthetic_euroc, tmp_path):
    """One present sequence + a missing one -> a partial table."""
    mav0, _, _, config = synthetic_euroc
    root = tmp_path / "euroc_root"
    (root / "MH_01_easy").mkdir(parents=True)
    shutil.copytree(mav0, root / "MH_01_easy" / "mav0")
    summary = sweep(config, str(root), sequences=("MH_01_easy", "V1_01_easy"), out_dir=str(tmp_path / "out"),
                    device="cpu")
    assert len(EUROC_SEQUENCES) == 11
    assert summary["n_ok"] == 1 and summary["n_missing"] == 1
    mh = summary["sequences"]["MH_01_easy"]
    assert mh["status"] == "ok"
    assert mh["ate_rmse_m"] is None or mh["ate_rmse_m"] < 1.0
    assert os.path.exists(mh["trajectory"])
    assert summary["sequences"]["V1_01_easy"]["status"] == "missing"


def test_checkpoint_resume_cli(synthetic_euroc, tmp_path):
    """Run the first half with checkpoint_out, resume a fresh pipeline from
    the checkpoint for the second half, and keep tracking."""
    mav0, _, rig, config = synthetic_euroc
    ckpt = str(tmp_path / "half.ckpt")
    kw = dict(dtype=torch.float64, rig=rig, device="cpu")
    out1 = run(config, mav0, trajectory_out=str(tmp_path / "t1.tum"), max_frames=5, checkpoint_out=ckpt, **kw)
    assert out1["frames_processed"] >= 3
    assert os.path.exists(ckpt) and os.path.exists(ckpt + ".est")
    out2 = run(config, mav0, 0.5, trajectory_out=str(tmp_path / "t2.tum"), resume=ckpt, **kw)
    assert out2["frames_processed"] >= 4, out2
    assert out2["ate_rmse_m"] is not None and out2["ate_rmse_m"] < 0.2, out2


def test_run_euroc_with_posegraph(synthetic_euroc, tmp_path):
    """tests/test_posegraph.py::TestPipelineIntegration: keyframes flow into
    the graph, the app reports the pose graph's outputs, VIO quality holds,
    and a short run that does not revisit closes no loop."""
    mav0, _, rig, config = synthetic_euroc
    out = run(config, mav0, dtype=torch.float64, trajectory_out=str(tmp_path / "traj.tum"), rig=rig,
              loop_closure=True, device="cpu")
    assert out["frames_processed"] >= 6
    assert out["posegraph_keyframes"] >= 2
    assert out["ate_rmse_m"] is not None and out["ate_rmse_m"] < 0.2
    assert out["loop_closures"] == 0
    assert os.path.exists(tmp_path / "traj.tum.loop")
