"""The port's bench tools (okvis_tpu_torch.bench) against the JAX package's,
on the CPU: the accuracy proxy's scenarios, nuisance, bounds and gate
(scripts/accuracy_proxy.py, run in a subprocess: the JAX scripts configure
the whole process when imported), the BA window of bench.py and one
optimize of it, the deadline contract's rule and its trust0 chain, the
capacity tiers, the pose-graph bench and detect_and_describe; and every
tool's command line on the CPU and its refusal to run without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from okvis_tpu_torch import convert
from okvis_tpu_torch.bench import accuracy_proxy, bench_deadline, bench_posegraph, bench_tiers, common

REPO = Path(__file__).resolve().parents[1]
SCENARIO_FRAMES = 12
NUISANCE_CALLS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (frame, camera) in order
# runs of (config, scenario) cells for _gate: ATEs, frames tracked of fed
GATE_CASES = [
    ("stereo", "loop", [(0.2, 318, 320), (0.5, 320, 320), (0.3, 320, 320)]),
    ("stereo", "photometric", [(0.19, 300, 300), (0.21, 300, 300), (None, 300, 300)]),
    ("mono", "photometric", [(0.45, 300, 300)]),
    ("extrinsics", "planar_wall", [(1.9, 300, 300), (2.2, 284, 300)]),
    ("loopclosure", "loop", [(3.7, 320, 320), (0.3, 320, 320), (1.1, 320, 320)]),
    ("distributed8", "planar_wall", []),
]

JAX_SIDE = r"""
import json, sys
import numpy as np
sys.path.insert(0, "scripts")
import accuracy_proxy as ap

out = {}
for name, make in ap.SCENARIOS.items():
    for seed in (0, 1):
        traj, lms, _ = make(n_frames=int(sys.argv[3]), seed_offset=seed)
        for k in ("ts", "r", "q", "gyro", "acc"):
            out[f"{name}/{seed}/{k}"] = getattr(traj, k)
        out[f"{name}/{seed}/landmarks"] = lms
images = np.load(sys.argv[2])["images"]
_, _, nuisance = ap.scenario_photometric(n_frames=int(sys.argv[3]))
for i, (fi, cam) in enumerate(json.loads(sys.argv[4])):
    out[f"nuisance/{i}"] = nuisance(images[i], fi, cam)
out["box_blur"] = ap._box_blur(images[0].astype(np.float64), 3)
gates = [list(ap._gate(c, s, [dict(ate_m=a, frames=f, fed=n) for a, f, n in runs]))
         for c, s, runs in json.loads(sys.argv[5])]
out["tables"] = np.asarray(json.dumps(dict(bounds=ap.BOUNDS_M, scale=ap.CONFIG_BOUND_SCALE,
                                           configs=ap.CONFIG_VARIANTS, gates=gates)))
np.savez(sys.argv[1], **out)
"""


def _images():
    return np.random.default_rng(3).uniform(0, 255, (4, 48, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_proxy(tmp_path_factory):
    """scripts/accuracy_proxy.py's scenarios, nuisance, tables and gates,
    computed in a JAX_PLATFORMS=cpu subprocess."""
    tmp = tmp_path_factory.mktemp("proxy")
    np.savez(tmp / "images.npz", images=_images())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", JAX_SIDE, str(tmp / "out.npz"), str(tmp / "images.npz"),
                    str(SCENARIO_FRAMES), json.dumps(NUISANCE_CALLS), json.dumps(GATE_CASES)],
                   cwd=REPO, env=env, check=True, timeout=600, capture_output=True)
    with np.load(tmp / "out.npz") as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(accuracy_proxy.SCENARIOS))
def test_accuracy_scenarios_match_jax(jax_proxy, name, seed):
    traj, lms, _ = accuracy_proxy.SCENARIOS[name](n_frames=SCENARIO_FRAMES, seed_offset=seed)
    for k in ("ts", "r", "q", "gyro", "acc"):
        assert np.array_equal(getattr(traj, k), jax_proxy[f"{name}/{seed}/{k}"]), k
    assert np.array_equal(lms, jax_proxy[f"{name}/{seed}/landmarks"])


def test_photometric_nuisance_and_box_blur_match_jax(jax_proxy):
    images = _images()
    _, _, nuisance = accuracy_proxy.scenario_photometric(n_frames=SCENARIO_FRAMES)
    for i, (fi, cam) in enumerate(NUISANCE_CALLS):
        assert np.array_equal(nuisance(images[i], fi, cam), jax_proxy[f"nuisance/{i}"]), i
    assert np.array_equal(accuracy_proxy._box_blur(images[0].astype(np.float64), 3), jax_proxy["box_blur"])


def test_bounds_configs_and_gate_match_jax(jax_proxy):
    tables = json.loads(str(jax_proxy["tables"]))
    assert accuracy_proxy.BOUNDS_M == tables["bounds"]
    assert accuracy_proxy.CONFIG_BOUND_SCALE == tables["scale"]
    assert accuracy_proxy.CONFIG_VARIANTS == tables["configs"]
    for (config, scen, runs), want in zip(GATE_CASES, tables["gates"]):
        got = accuracy_proxy._gate(config, scen, [dict(ate_m=a, frames=f, fed=n) for a, f, n in runs])
        assert [str(x) for x in got] == [str(x) for x in want], (config, scen)


# ------------------------------------------------- the BA window and the deadline


@pytest.fixture(scope="module")
def jax_window():
    """bench.py's EuRoC window built by the JAX package in float64; its
    3-iteration optimize, then two 1-iteration continuations from the
    carried damping (scripts/bench_deadline.py's programs)."""
    import dataclasses
    import functools

    import jax

    from okvis_tpu.datasets.synthetic import build_ba_problem
    from okvis_tpu.solver import optimize_window

    cfg, imu, intr, problem, _ = build_ba_problem(**common.EUROC_WINDOW)
    opt3 = jax.jit(functools.partial(optimize_window, cfg, imu, intr))
    opt1 = jax.jit(functools.partial(optimize_window, dataclasses.replace(cfg, max_iterations=1), imu, intr))
    chain = [opt3(problem)]
    for _ in range(2):
        states, diag = chain[-1]
        chain.append(opt1(problem._replace(states=states), diag.final_lambda))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(problem=tree(problem), chain=[(tree(s), tree(d)) for s, d in chain])


def _as_dict(tree):
    if hasattr(tree, "_asdict"):
        return {k: _as_dict(v) for k, v in tree._asdict().items()}
    return None if tree is None else np.asarray(tree)


def _compare(got: dict, want: dict, path=""):
    """Slot for slot to 1e-12 of the largest |value| of each array."""
    for k, w in want.items():
        if isinstance(w, dict):
            _compare(got[k], w, f"{path}.{k}")
        elif w is not None and k in got and got[k] is not None:
            g = got[k]
            assert g.shape == w.shape, (path, k, g.shape, w.shape)
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=0,
                                       atol=1e-12 * max(np.abs(w).max(), 1e-300), err_msg=f"{path}.{k}")


def test_ba_bench_window_matches_jax(jax_window):
    cfg, imu, intr, problem, _ = common.build_window("cpu", torch.float64)
    assert (cfg.num_states, cfg.max_landmarks, cfg.max_observations, cfg.max_iterations, cfg.imu_samples,
            cfg.max_imu_links) == (8, 512, 2048, 3, 24, 7)
    _compare(convert.problem_to_numpy(problem), _as_dict(jax_window["problem"]))
    assert int(problem.obs.mask.sum()) == int(jax_window["problem"].obs.mask.sum())


def _assert_states_match(states, diag, jstates, jdiag):
    """tests/test_torch_backend.py's LM + Newton-Schulz tolerances."""
    np.testing.assert_array_equal(diag.accepted.numpy(), np.asarray(jdiag.accepted))
    want = np.asarray(jdiag.cost_history)
    np.testing.assert_allclose(diag.cost_history.numpy(), want, rtol=0, atol=1e-8 * np.abs(want).max())
    for name in ("r_WS", "q_WS", "speed_and_bias", "hp_W"):
        np.testing.assert_allclose(getattr(states, name).numpy(), np.asarray(getattr(jstates, name)), rtol=0,
                                   atol=1e-8, err_msg=name)


def test_ba_bench_optimize_matches_jax(jax_window):
    from okvis_tpu_torch.solver import optimize_window

    cfg, imu, intr, problem, _ = common.build_window("cpu", torch.float64)
    states, diag = optimize_window(cfg, imu, intr, problem)
    _assert_states_match(states, diag, *jax_window["chain"][0])
    assert bool(diag.accepted.any())


def test_deadline_chain_matches_jax_optimize_window(jax_window):
    """The contract's programs in float64: the min-iteration solve and two
    continuations equal JAX's optimize_window on the same trust0 chain."""
    cfg, imu, intr, problem, _ = common.build_window("cpu", torch.float64)
    run_min, run_chunk = bench_deadline.programs(cfg, imu, intr, problem)
    state = run_min()
    for step in range(3):
        if step:
            state = run_chunk(state)
        _assert_states_match(*state, *jax_window["chain"][step])


class _Clock:
    """A fake clock: each call returns the time, which a run then advances."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fake_programs(clock, min_cost, chunk_costs):
    costs = iter(chunk_costs)

    def run_min():
        clock.t += min_cost
        return 0

    def run_chunk(state):
        clock.t += next(costs)
        return state + 1

    return run_min, run_chunk


def _rule(min_cost, chunk_costs, limit, min_iters, max_iters):
    """scripts/bench_deadline.py:81-104's rule on a run of known costs."""
    elapsed, iters, ema = min_cost, min_iters, None
    for c in chunk_costs:
        if iters >= max_iters or elapsed + (ema if ema is not None else elapsed) > limit:
            break
        elapsed += c
        ema = c if ema is None else 0.5 * ema + 0.5 * c
        iters += 1
    return iters, elapsed


@pytest.mark.parametrize("limit,expect", [(0.0, "min"), (1e9, "max"), (0.080, "middle")])
def test_deadline_loop_follows_the_rule(limit, expect):
    min_cost, chunk_costs = 0.020, [0.010, 0.014, 0.006, 0.012, 0.009, 0.011, 0.008, 0.010]
    clock = _Clock()
    state, iters, elapsed = bench_deadline.deadline_loop(*_fake_programs(clock, min_cost, chunk_costs), limit,
                                                         3, 10, clock=clock)
    want_iters, want_elapsed = _rule(min_cost, chunk_costs, limit, 3, 10)
    assert (iters, state) == (want_iters, want_iters - 3) and elapsed == pytest.approx(want_elapsed)
    if expect == "min":
        assert iters == 3 and elapsed > limit  # an overrun
    elif expect == "max":
        assert iters == 10
    else:
        assert 3 < iters < 10 and elapsed <= limit + max(chunk_costs)


def test_tiers_give_the_same_final_cost_in_float64():
    out = bench_tiers.run(reps=1, device="cpu", dtype=torch.float64, verbose=False)
    assert [(t["L"], t["O"]) for t in out["tiers"]] == list(bench_tiers.TIERS)
    assert len({t["active_observations"] for t in out["tiers"]}) == 1
    assert out["max_cost_rel_diff"] <= 1e-9


def test_posegraph_bench_fields_and_query_match_jax():
    from okvis_tpu.posegraph.place_recognition import KeyframeDatabase as JDatabase

    out = bench_posegraph.run(nodes=(32,), reps=1, frames=16, query_reps=1, device="cpu", verbose=False)
    assert json.loads(json.dumps(out)) == out
    assert [(r["nodes"], r["solver"]) for r in out["pgo"]] == [(32, "pcg"), (32, "dense")]
    for r in out["pgo"]:
        assert {"ms", "first_call_ms", "initial_cost", "final_cost", "kernel_ms", "launches"} <= set(r)
        assert np.isfinite(r["ms"]) and r["final_cost"] < r["initial_cost"]
    q = out["query"]
    assert q["hamming_shape"] == [400, 16 * 400] and np.isfinite(q["ms"])
    # the JAX package's database on the same keyframes and query
    rng = np.random.default_rng(0)
    jdb = JDatabase(frame_capacity=16, kp_capacity=400)
    geo = (np.zeros((400, 3)), np.zeros((400, 3)), np.ones(400, bool))
    for i in range(16):
        jdb.insert(i, rng.integers(0, 256, (400, 64), dtype=np.uint8), np.ones(400, bool), *geo)
    jcand, jscore, _ = jdb.query(rng.integers(0, 256, (400, 64), dtype=np.uint8), np.ones(400, bool),
                                 exclude_ids=set())
    assert (q["candidate"], q["score"]) == (jcand, jscore)


def test_detect_and_describe_matches_jax():
    import jax.numpy as jnp

    from okvis_tpu.frontend import detect_and_describe as jdetect_and_describe
    from okvis_tpu_torch.bench.bench_pipeline import bench_world, euroc_rig, render_frame
    from okvis_tpu_torch.frontend import detect_and_describe

    traj, lms = bench_world(4, 260)
    img = render_frame(euroc_rig("cpu"), traj, lms, 2)[0]
    kt, dt = detect_and_describe(torch.from_numpy(img), threshold=15.0, max_keypoints=200,
                                 extraction_angle=torch.tensor(0.3))
    kj, dj = jdetect_and_describe(jnp.asarray(img), threshold=15.0, max_keypoints=200,
                                  extraction_angle=jnp.asarray(0.3, jnp.float32))
    m = kt.mask.numpy()
    assert m.sum() > 30
    np.testing.assert_array_equal(m, np.asarray(kj.mask))
    # subpixel refinement to float32 rounding (tests/test_torch_detection.py: 1e-3 px)
    np.testing.assert_allclose(kt.uv.numpy()[m], np.asarray(kj.uv)[m], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(dt.numpy()[m], np.asarray(dj).view(np.int32)[m])


# ------------------------------------------------------------- the command lines

# each tool's command line at a reduced size (the pipeline's, bench's, the
# host table's and the accuracy cell's: tests/test_torch_bench_pipeline.py)
REDUCED = {
    "bench_posegraph": ["--nodes", "16", "--frames", "4", "--reps", "1", "--query-reps", "1"],
    "bench_deadline": ["2"],
    "bench_tiers": ["--reps", "1"],
    "profile_ba": ["--reps", "1"],
    "bench_detect": ["--reps", "1"],
    "bench_big_window": ["--windows", "euroc", "--reps", "1"],
    "bench_scaling": ["--counts", "1", "2", "--n-iter", "1"],
    "study_relpose": ["1"],
}
ALL_TOOLS = sorted(list(REDUCED) + ["bench_pipeline", "bench_host", "bench", "accuracy_proxy"])


@pytest.mark.parametrize("name", sorted(REDUCED))
def test_tool_runs_on_the_cpu_when_asked(name, tmp_path, capsys):
    import importlib

    mod = importlib.import_module(f"okvis_tpu_torch.bench.{name}")
    out = tmp_path / "out.json"
    mod.main(REDUCED[name] + ["--device", "cpu", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(out.read_text()) and line["device"] == "cpu"


@pytest.mark.parametrize("name", ALL_TOOLS)
def test_tool_raises_without_a_card(name, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"okvis_tpu_torch.bench.{name}")
    args = {"accuracy_proxy": ["--cell", "stereo", "photometric", "0"]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)
