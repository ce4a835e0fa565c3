"""The port's pipeline bench on the CPU (okvis_tpu_torch.bench.bench_pipeline):
a short run's result, the five captured per-frame programs (the JAX
package's capture tags: okvis_tpu/frontend/frontend.py:173-195, :604-608,
okvis_tpu/estimator/estimator.py), each replay bitwise equal to the call it
captured, capture's clones; and the command lines that drive the pipeline:
bench_pipeline, bench_host, bench and the accuracy proxy's --cell and
--matrix."""

import json
import math

import pytest
import torch

from okvis_tpu_torch.bench import accuracy_proxy, bench_pipeline
from okvis_tpu_torch.utils import capture

PROGRAMS = ("detect", "associate", "propagate", "optimize", "marginalize")
KEYS = ("value", "vs_baseline", "ate_m", "blocking_syncs_per_frame", "device_ms_per_frame", "device_fps_ceiling",
        "device_ms_per_frame_rt", "device_fps_ceiling_rt", "median_frame_ms", "max_frame_ms", "wall_s",
        "detect_syncs_per_frame")


@pytest.fixture(scope="module")
def run():
    """6 frames, 2 of warm-up, on the CPU; the captured programs kept."""
    out = bench_pipeline.run_pipeline_bench(6, device="cpu", warmup=2, wall_reps=2, kernel_reps=1, verbose=False)
    return out, capture.programs(), capture.outputs()


@pytest.mark.parametrize("key", KEYS)
def test_result_key_is_present_and_finite(run, key):
    value = run[0][key]
    assert isinstance(value, float) and math.isfinite(value) and value >= 0, (key, value)


def test_result_is_one_json_line_with_every_frame_tracked(run):
    out = run[0]
    assert json.loads(json.dumps(out)) == out
    assert (out["metric"], out["unit"], out["frames"], out["frames_fed"]) == ("pipeline_frames_per_s", "frames/s", 6, 6)
    assert out["ate_m"] < accuracy_proxy.BOUNDS_M["photometric"]
    assert len(out["frame_ms"]) == 6 and out["opt_latency_ms"]["p99"] >= out["opt_latency_ms"]["p50"] > 0
    assert out["device_time"] == "replay wall ms (CPU)"
    assert out["device_fps_ceiling"] == pytest.approx(1e3 / out["device_ms_per_frame"])
    assert out["stages"]["3.1 optimization"]["count"] == 4  # the frames after the warm-up
    assert {"host: assoc tables (np)", "host: build problem", "host: optimize update"} <= set(
        out["host_stage_ms_per_frame"])


def test_the_five_programs_of_the_jax_package_are_captured(run):
    out, progs, outs = run
    assert sorted(progs) == sorted(PROGRAMS) == out["programs_captured"]
    assert sorted(outs) == sorted(PROGRAMS) and sorted(out["programs"]) == sorted(PROGRAMS)
    assert not capture.enabled


@pytest.mark.parametrize("tag", PROGRAMS)
def test_replay_is_bitwise_equal_to_the_captured_call(run, tag):
    out, progs, outs = run
    assert out["programs"][tag]["bitwise_equal"] is True
    fn, args, kw = progs[tag]
    from okvis_tpu_torch.bench.common import tree_equal

    assert tree_equal(fn(*args, **kw), outs[tag])


def test_min_iteration_replay(run):
    rt = run[0]["optimize_min_iterations"]
    assert rt["min_iterations"] == 3 and rt["device_ms"] > 0
    assert run[0]["device_ms_per_frame_rt"] < run[0]["device_ms_per_frame"]


def test_capture_records_clones_and_nothing_when_off():
    t = torch.arange(4.0)
    capture.reset()
    capture.record("x", torch.neg, t)
    assert capture.programs() == {}
    capture.enabled = True
    try:
        capture.record("x", torch.neg, t, out=None)
        capture.record_output("x", (t, [t]))
    finally:
        capture.enabled = False
    t.add_(10.0)  # the pipeline updates some tensors in place after a call
    fn, (arg,), kw = capture.programs()["x"]
    out, out_list = capture.outputs()["x"]
    assert fn is torch.neg and kw == {"out": None}
    assert torch.equal(arg, torch.arange(4.0)) and torch.equal(out, torch.arange(4.0))
    assert torch.equal(out_list[0], torch.arange(4.0)) and arg.data_ptr() != t.data_ptr()
    capture.reset()
    assert capture.programs() == {} and capture.outputs() == {}


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_pipeline_command_line(capsys, tmp_path):
    bench_pipeline.main(["4", "--device", "cpu", "--out", str(tmp_path / "p.json")])
    line = _last_json(capsys)
    assert line == json.loads((tmp_path / "p.json").read_text()) and line["frames"] == 4


def test_bench_host_command_line(capsys):
    from okvis_tpu_torch.bench import bench_host

    bench_host.main(["4", "--device", "cpu"])
    line = _last_json(capsys)
    assert line["keypoints"] == 400 and line["world_landmarks"] == 600
    assert set(line["stages_ms_per_frame"]) == set(bench_host.PURE)
    assert line["value"] == pytest.approx(sum(line["stages_ms_per_frame"].values()))


def test_bench_headline_command_line(capsys):
    from okvis_tpu_torch.bench import bench

    bench.main(["--frames", "4", "--ba-iters", "1", "--device", "cpu"])
    line = _last_json(capsys)
    assert line["metric"] == "pipeline_frames_per_s" and line["vs_baseline"] == pytest.approx(line["value"] / 20.0)
    for key in ("device_fps_ceiling", "ba_optimize_steps_per_s", "host_bookkeeping_ms_per_frame", "ate_m"):
        assert math.isfinite(line[key]) and line[key] > 0, key


def test_accuracy_cell_command_line(capsys):
    assert accuracy_proxy.main(["--cell", "stereo", "photometric", "0", "--frames", "5", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("CELL ")]
    rec = json.loads(lines[-1][5:])
    assert (rec["config"], rec["scenario"], rec["fed"], rec["frames"]) == ("stereo", "photometric", 5, 5)
    assert rec["ate_m"] < accuracy_proxy.BOUNDS_M["photometric"]


def test_accuracy_matrix_runs_each_cell_in_a_subprocess(tmp_path, capsys):
    out = tmp_path / "matrix.json"
    rc = accuracy_proxy.main(["--matrix", "loopclosure", "planar_wall", "--frames", "6", "--seeds", "1",
                              "--device", "cpu", "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert list(res) == ["loopclosure/planar_wall"] and res["loopclosure/planar_wall"]["ok"]
    (rec,) = res["loopclosure/planar_wall"]["runs"]
    traj, _, _ = accuracy_proxy.scenario_planar_wall(n_frames=6)
    assert rec["fed"] == rec["frames"] == int(traj.ts[-1] / 0.1) - 2 == 6 and rec["loop_events"] is not None
