"""The port's Estimator equals the JAX Estimator after every frame of a
7-frame run in float64 on the CPU: build_estimator_world's world (seed 13,
150 landmarks, half of the visible ones observed after the first frame, so
landmarks leave the window; one is removed at frame 7), L = 128, O = 512, LM +
Newton-Schulz, shared extrinsics fixed. Both packages get the same numpy
frames with explicit frame ids; the tolerances are those of
test_torch_estimator.py. Then the round trip: the JAX window after 6 frames
carried into the port by convert.estimator_from_numpy, which runs frame 7
to the JAX window after it."""

import pytest

from test_torch_estimator import assert_same_window, round_trip, run_parity

N_FRAMES = 7


@pytest.fixture(scope="module")
def run():
    return run_parity(seed=13, n_frames=N_FRAMES, n_landmarks=150, keep=0.5)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_window_matches_jax_after_frame(run, frame):
    assert_same_window(run["port"][frame], run["jax"][frame], f"frame {frame + 1}")


def test_run_removes_landmarks_and_marginalizes(run):
    """The run exercises the triage: a landmark is removed, and the prior
    is valid from the first marginalization on."""
    assert any(s["removed"] for s in run["jax"])
    assert run["jax"][-1]["marg_valid"] and len(run["jax"][-1]["states"]) == 5


def test_round_trip_through_estimator_from_numpy(run):
    round_trip(run)
