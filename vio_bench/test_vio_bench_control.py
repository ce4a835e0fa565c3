"""The comparison that decides `correct` has to fail what it is there to
catch.

- On the card (`cuda` marker; skips without one): the control, the
  reference in the program's place with its Harris arithmetic in bfloat16
  and its descriptors' blur matmuls in TF32, fails the cell's limits on
  three seeds, at the cell's own size, while the program passes them.
- On the CPU: a run with the timed path broken underneath the benchmark's
  taps comes out not correct, once for each fault a cell can have: a solve
  that returns the window unchanged, half of a distance-matrix batch left
  out, every descriptor altered where the frontend produces it, and a
  published pose that never moves. (No cell spans chips, so no exchange
  between chips can be left out.)

    python -m pytest vio_bench/test_vio_bench_control.py -q
"""

from __future__ import annotations

import time

import pytest
import torch

from vio_bench import control, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's matmuls run in TF32 on the card")
    limits = harness.load_json(harness.limits_file(cell))
    for seed in (71, 72, 73):
        result, _ = harness.run(cell, seed, 5.0, False, time.perf_counter(), control=control.control_readings)
        assert result["correct"], result["checks"]
        for name, value in result["control"].items():
            assert value > limits[name], (name, result["control"])


# seconds of window on the CPU (~1.5 s a frame): a solve left out shows
# once the states have drifted on the IMU alone for a while, a frozen pose
# once the lap has turned the rig by some degrees
WINDOW_S = {"optimize_unchanged": 240.0, "hamming_half_batch": 5.0, "descriptor_altered": 5.0,
            "pose_frozen": 60.0}


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_fault_is_not_correct(fault):
    torch.set_num_threads(4)
    result = control.run_fault("euroc_stereo.lap", fault, 2**31 + 5, WINDOW_S[fault], device="cpu")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", [c for c in CELLS if c != "euroc_stereo.lap"])
def test_frozen_pose_is_not_correct_in_every_cell(cell):
    torch.set_num_threads(4)
    result = control.run_fault(cell, "pose_frozen", 2**31 + 5, WINDOW_S["pose_frozen"], device="cpu")
    assert result["correct"] is False, result["checks"]
