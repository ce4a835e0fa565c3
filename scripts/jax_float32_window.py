#!/usr/bin/env python3
"""The JAX package's optimize_window in float32 on the CPU, on the window
that chip_smoke.py solves on the card: build_ba_problem(num_frames=9,
frame_stride=20, n_landmarks=400, duration=2.0, seed=5) at L = 512,
P = 32, K = 8, perturbed with numpy seed 7 (pose scale 0.05, landmark
scale 0.1, tests/test_solver.py's helper). Runs LM and dogleg with both
dense solvers and prints, per run, the accept flags, the cost history and
the reference gates' errors (TestEstimator: position < 0.1 m, orientation
< 1e-2 rad, speed/bias < 0.04, final cost < 0.1 x the perturbed cost).

It shows what the reference does in float32 on that window, the precision
the port runs on the card:

    JAX_PLATFORMS=cpu python scripts/jax_float32_window.py

About two minutes on a CPU, most of it in build_ba_problem.
"""

import dataclasses
import functools
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")  # float32: x64 stays off

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from okvis_tpu import kinematics as kin  # noqa: E402
from okvis_tpu.datasets.synthetic import build_ba_problem  # noqa: E402
from okvis_tpu.solver import evaluate, optimize_window  # noqa: E402
from test_solver import perturb_problem  # noqa: E402


def main() -> None:
    cfg, imu, intr, problem, truth = build_ba_problem(
        num_frames=9, frame_stride=20, n_landmarks=400, duration=2.0, seed=5,
        cfg_kwargs=dict(max_landmarks=512, imu_samples=32, max_imu_links=8))
    perturbed = perturb_problem(problem, truth, np.random.default_rng(7))
    cost0 = float(evaluate(cfg, imu, intr, perturbed, perturbed.states).cost)
    S = cfg.num_states
    for algorithm in ("lm", "dogleg"):
        for solver in ("newton", "cholesky"):
            c = dataclasses.replace(cfg, algorithm=algorithm, dense_solver=solver)
            states, diag = jax.jit(functools.partial(optimize_window, c, imu, intr))(perturbed)
            dq = kin.quat_multiply(kin.quat_conjugate(states.q_WS[:S]),
                                   jnp.asarray(truth["q_WS"], jnp.float32))
            ang = 2 * jnp.arctan2(jnp.linalg.norm(dq[:, :3], axis=-1), jnp.abs(dq[:, 3]))
            row = dict(
                dtype=str(states.r_WS.dtype), algorithm=algorithm, dense_solver=solver,
                accepted=np.asarray(diag.accepted).tolist(),
                cost_history=np.asarray(diag.cost_history).tolist(), cost0=cost0,
                position=float(np.abs(np.asarray(states.r_WS[:S]) - truth["r_WS"]).max()),
                orientation=float(ang.max()),
                speed_bias=float(np.abs(np.asarray(states.speed_and_bias[:S]) - truth["sb"]).max()),
            )
            row["gates"] = (row["position"] < 0.1 and row["orientation"] < 1e-2
                            and row["speed_bias"] < 0.04 and row["cost_history"][-1] < 0.1 * cost0)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
