"""The port's Estimator equals the JAX Estimator after every frame of a
7-frame run with online calibration of the shared extrinsics block
(estimate_extrinsics=True, the "absolute" configuration of
tests/test_estimator.py:168), in float64 on the CPU: build_estimator_world's
world with seed 21, 110 landmarks, 60 % of the visible ones observed after
the first frame, L = 128, O = 512, LM + Newton-Schulz. Tolerances as in
test_torch_estimator.py; then the round trip through
convert.estimator_from_numpy at frame 6."""

import numpy as np
import pytest

from test_torch_estimator import assert_same_window, round_trip, run_parity

N_FRAMES = 7


@pytest.fixture(scope="module")
def run():
    return run_parity(seed=21, n_frames=N_FRAMES, n_landmarks=110, keep=0.6, estimate_extrinsics=True)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_window_matches_jax_after_frame(run, frame):
    assert_same_window(run["port"][frame], run["jax"][frame], f"frame {frame + 1}")


def test_extrinsics_are_estimated_and_frozen(run):
    """The extrinsics move off their nominal values and their FEJ point is
    frozen at the first marginalization, in both packages."""
    first, last = run["jax"][0], run["jax"][-1]
    assert last["fej_ext_frozen"] and run["port"][-1]["fej_ext_frozen"]
    assert np.abs(last["r_SC"] - first["fej_r_SC"]).max() > 0


def test_round_trip_through_estimator_from_numpy(run):
    round_trip(run)
