"""The Estimator's batched preintegration of its IMU links
(`Estimator._preintegrate_links`) against the eager `preintegrate` on the
same padded tables. On the CPU the Estimator calls `preintegrate` itself and
never records a CUDA graph; tests/test_torch_cuda.py holds the card's graph
replay to the same eager call, bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from okvis_tpu_torch.cameras.ncamera import NCameraSystem
from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig, simulate_trajectory
from okvis_tpu_torch.estimator import Estimator
from okvis_tpu_torch.imu.preintegration import ImuParams, preintegrate
from okvis_tpu_torch.utils.timing import Timing

torch.set_num_threads(2)


def estimator_with_links(device, dtype, n_states=9, seed=5):
    """An Estimator at the benchmark's window (5 keyframes + 3 frames: K = 8
    links of P = 32 samples) after add_states for n_states frames of a
    synthetic flight at 10 Hz, with distinct gyro and accelerometer biases
    in its current (`sb`) and FEJ (`fej_sb`) tables."""
    traj = simulate_trajectory(duration=0.1 * n_states + 0.1, seed=seed, motion_scale=0.5)
    specs, T_SC, intr = euroc_stereo_rig(device=device)
    est = Estimator(NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr), ImuParams.euroc(dtype, device),
                    dtype=dtype, device=device)
    for i in range(n_states):
        idx = 20 * i
        lo, hi = max(0, idx - 24), idx + 5
        est.add_states(0.1 * i, traj.ts[lo:hi], traj.gyro[lo:hi], traj.acc[lo:hi], as_keyframe=i % 2 == 0,
                       frame_id=i + 1)
    rng = np.random.default_rng(seed)
    est.sb[:, 3:9] += rng.normal(0.0, 0.02, (len(est.sb), 6))
    est.fej_sb[:, 3:9] += rng.normal(0.0, 0.02, (len(est.fej_sb), 6))
    return est


def timer_count(name: str) -> int:
    return Timing._timers[name].count if name in Timing._timers else 0


@pytest.fixture(scope="module")
def est():
    return estimator_with_links("cpu", torch.float64)


@pytest.mark.parametrize("n_links", [8, 2])
@pytest.mark.parametrize("table", ["sb", "fej_sb"])
def test_cpu_estimator_preintegrates_eagerly(est, n_links, table):
    """Optimize's call (every link, current biases) and marginalization's
    (the oldest links, FEJ biases): every field equals the eager call's on
    the same padded tables, and nothing is captured or replayed."""
    assert (est.cfg.max_imu_links, est.cfg.imu_samples, len(est.imu_links)) == (8, 32, 8)
    links, sb = est.imu_links[:n_links], getattr(est, table)
    counts = timer_count("preintegrate.capture"), timer_count("preintegrate.replay")
    got = est._preintegrate_links(links, sb)
    want = preintegrate(est.imu_params, *(est._t(x) for x in est._link_tables(links, sb)))
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    assert float(got.delta_t[n_links - 1]) > 0.09 and not got.delta_t[n_links:].any()
    assert (timer_count("preintegrate.capture"), timer_count("preintegrate.replay")) == counts
    fn = est._jit_cache["pre"]
    assert isinstance(fn, functools.partial) and fn.func is preintegrate
