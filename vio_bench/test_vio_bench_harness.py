"""CPU tests of the benchmark's harness: every file is found by name, the
streams repeat their lap exactly, a tiny run's result line has the keys
the check reads, and neither the run nor the reference loads JAX or the
JAX package (nor does the reference load the port).

    python -m pytest vio_bench/test_vio_bench_harness.py -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from vio_bench import harness, world
from vio_bench.reference import geometry

ROOT = harness.ROOT


def test_every_file_is_found_by_name():
    b = harness.benchmark()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert harness.load_json(ROOT / c["file"])["name"] == c["name"]
    for w in b["workloads"]:
        assert harness.config_file(w["config"]).is_file()
        assert harness.traffic_file(w["traffic"]).is_file()
        # the five numbers of every cell, and the pose graph's five where the configuration runs the layer
        posegraph = harness.posegraph_parameters(harness.load_json(harness.config_file(w["config"]))["posegraph"])
        assert set(harness.load_json(harness.limits_file(w["name"]))) == {
            "keypoints_unmatched", "descriptor_bits_differ", "hamming_entries_differ", "ate_m", "rot_err_deg"} | (
            {"posegraph_scores_differ", "loop_edge_err_m", "loop_edge_err_deg", "posegraph_solve_err_m",
             "posegraph_solve_err_rad"} if posegraph.enabled else set())
    for m in b["per_layer"]:
        read = harness.metric_reader(m["name"])
        assert read({}) is None  # nothing to read: nothing reported
    for m in b["end_to_end"] + b["per_layer"]:
        for cell in m.get("workloads", []):
            harness.find_cell(cell)


@pytest.mark.parametrize("traffic", ["lap", "spin"])
def test_stream_repeats_its_lap(traffic):
    config = harness.load_json(harness.config_file("euroc_stereo"))
    spec = harness.load_json(harness.traffic_file(traffic))
    s = world.make_stream(config, spec, 2**31 + 7, "cpu")
    F, N = s.lap_frames, s.lap_samples
    assert F == round(spec["lap_s"] * 20) and N == round(spec["lap_s"] * 200)
    # fed lap after lap: the same images and readings, the stamps going on
    for n in (0, 3, F - 1):
        assert all(np.array_equal(a, b) for a, b in zip(s.frame_images(n), s.frame_images(n + F)))
        assert s.frame_ns(n + F) - s.frame_ns(n) == int(spec["lap_s"] * 1e9)
    for i in (0, 17, N - 1):
        assert all(np.array_equal(a, b) for a, b in zip(s.imu_sample(i), s.imu_sample(i + 2 * N)))
    # the closed form itself closes the lap: motion and exact IMU one period on
    m, t = s.motion, np.linspace(0.0, spec["lap_s"], 9)
    np.testing.assert_allclose(m.position(t + m.lap_s), m.position(t), atol=1e-9)
    np.testing.assert_allclose(m.rotation(t + m.lap_s), m.rotation(t), atol=1e-9)
    for a, b in zip(m.imu(t + m.lap_s, 9.81), m.imu(t, 9.81)):
        np.testing.assert_allclose(a, b, atol=1e-9)
    # and the lap's first frame, rendered at the end of the lap, is frame 0
    landmarks, textures = world.make_scene(spec["scene"], m, 2**31 + 7)
    R_WC, r_WC = world.camera_poses(m, np.array([m.lap_s]), s.T_SC)
    again = world.render(config["cameras"], R_WC, r_WC, landmarks, textures, spec["scene"], 2**31 + 7, "cpu")
    assert np.array_equal(again[0], s.images[0])


def test_gyro_is_the_rate_of_the_rotation():
    spec = harness.load_json(harness.traffic_file("lap"))
    m = world.draw_motion(spec, 5)
    t, h = np.linspace(0.3, 9.7, 5), 1e-6
    R0, R1 = m.rotation(t), m.rotation(t + h)
    rel = np.swapaxes(R0, -1, -2) @ R1
    w_fd = np.stack([rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0], rel[:, 1, 0] - rel[:, 0, 1]], -1) / (2 * h)
    np.testing.assert_allclose(m.imu(t, 9.81)[0], w_fd, atol=1e-6)


def test_orientation_error_aligns_yaw_only():
    m = world.draw_motion(harness.load_json(harness.traffic_file("lap")), 11)
    R = m.rotation(np.arange(60) / 20.0)
    # quaternions (x, y, z, w) of a turn by 0.3 rad about z, and of 0.02 rad about x
    q = np.array([[0.0, 0.0, np.sin(0.15), np.cos(0.15)], [np.sin(0.01), 0.0, 0.0, np.cos(0.01)]])
    Rz, Rx = geometry.quat_to_rot(q)
    np.testing.assert_allclose(Rz, world.so3_exp(np.array([0.0, 0.0, 0.3])), atol=1e-12)
    assert geometry.orientation_error_deg(Rz @ R, R) < 1e-5  # the yaw of the world frame is free
    assert abs(geometry.orientation_error_deg(Rz @ Rx @ R, R) - np.degrees(0.02)) < 1e-6  # a tilt is not
    # a pose that never moves reads the lap's turning
    assert geometry.orientation_error_deg(np.repeat(R[:1], len(R), 0), R) > 5.0


@pytest.fixture(scope="module")
def tiny_runs():
    """A short untraced and traced run of the mono cell on the CPU (the
    harness's look for a card skipped): three warm-up frames, a window of one
    frame or more."""
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    return {traced: harness.run("euroc_mono.lap", 2**31 + 99, 0.5, traced, t0, device="cpu", warmup_frames=3)
            for traced in (False, True)}


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_run_result_line(tiny_runs, traced):
    result, lines = tiny_runs[traced]
    line = json.loads(json.dumps(result))
    # the keys the check reads; the compared numbers come last, each beside its limit
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in harness.cell_metrics("euroc_mono.lap", "per_layer" if traced else "end_to_end")}
    assert set(line["metrics"]) <= names
    if not traced:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert lines[-len(line["checks"]):] == [f"check {k}: {c['value']} limit {c['limit']}"
                                             for k, c in line["checks"].items()]


def test_cli_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "vio_bench.run", "--workload", "euroc_stereo.lap", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_nothing_loads_jax_and_the_reference_loads_no_port():
    ref = _loaded_after("import vio_bench.reference.detect, vio_bench.reference.hamming, "
                        "vio_bench.reference.geometry, vio_bench.reference.posegraph, vio_bench.check, "
                        "vio_bench.world")
    assert not ref & {"jax", "jaxlib", "flax", "okvis_tpu", "okvis_tpu_torch"}
    run = _loaded_after("import time, torch\nfrom vio_bench import harness, run\ntorch.set_num_threads(2)\n"
                        "harness.run('euroc_stereo.lap', 3, 0.1, False, time.perf_counter(), device='cpu', "
                        "warmup_frames=1)\nassert not run.forbidden_modules()")
    assert "okvis_tpu_torch" in run and not run & {"jax", "jaxlib", "flax", "okvis_tpu"}
