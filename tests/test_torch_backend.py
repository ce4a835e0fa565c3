"""The port's back end as a whole against the JAX package, in float64 on the
CPU, on build_ba_problem(num_frames=4, n_landmarks=96) carried across by
convert.problem_from_numpy: normal-equation assembly, both dense solvers,
LM and dogleg optimize_window, pinv_sym and marginalize_system, and the
chain build -> perturb -> optimize -> marginalize in both packages.

The JAX side runs once, in one module-scoped fixture (a few compiles):
XLA:CPU has crashed compiling optimize_window-class programs late in a long
process (tests/conftest.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu.datasets.synthetic import build_ba_problem as jbuild_ba_problem
from okvis_tpu.estimator.marginalization import marginalize_system as jmarginalize_system
from okvis_tpu.estimator.marginalization import pinv_sym as jpinv_sym
from okvis_tpu.solver import WindowConfig as JWindowConfig
from okvis_tpu.solver import evaluate as jevaluate
from okvis_tpu.solver import optimize_window as joptimize_window
from okvis_tpu.solver import solve_normal_eqs as jsolve_normal_eqs
from okvis_tpu.solver.assemble import NormalEqs as JNormalEqs
from okvis_tpu.solver.optimize import _landmark_quality as jlandmark_quality
from okvis_tpu.solver.optimize import _spd_solve_newton as jspd_solve_newton
from okvis_tpu_torch import convert
from okvis_tpu_torch.datasets.synthetic import build_ba_problem
from okvis_tpu_torch.estimator.marginalization import marginalize_system, pinv_sym
from okvis_tpu_torch.solver import WindowConfig, empty_problem, evaluate, optimize_window, solve_normal_eqs
from okvis_tpu_torch.solver.assemble import NormalEqs
from okvis_tpu_torch.solver.optimize import _landmark_quality, _spd_solve_newton, _sym3x3_eig_extremes

from test_marginalization import random_psd
from test_solver import perturb_problem

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _marg_masks(cfg, obs_np):
    """State 0's 15 dense dims, the other states' dims, and the landmarks
    that only state 0 observes (the estimator's marginalization of the
    oldest state)."""
    on = obs_np["mask"]
    sidx, lidx = obs_np["state_idx"][on], obs_np["lm_idx"][on]
    seen0, seen_other = np.zeros(cfg.max_landmarks, bool), np.zeros(cfg.max_landmarks, bool)
    seen0[lidx[sidx == 0]] = True
    seen_other[lidx[sidx != 0]] = True
    d = np.arange(cfg.dense_dim)
    return d < 15, (d >= 15) & (d < cfg.num_states * 15), seen0 & ~seen_other


@pytest.fixture(scope="module")
def world():
    """Both packages on the same perturbed window; the JAX results once."""
    jcfg, jimu, jintr, jproblem, truth = jbuild_ba_problem(num_frames=4, n_landmarks=96)
    jpert = perturb_problem(jproblem, truth, np.random.default_rng(7))
    cfg = convert.window_config_from_dict(dataclasses.asdict(jcfg))
    imu = convert.imu_params_from_numpy(_np_tree(jimu), device="cpu")
    intr = [torch.from_numpy(np.array(i)) for i in jintr]
    eval_fn = jax.jit(functools.partial(jevaluate, jcfg, jimu, jintr))
    jeqs = eval_fn(jpert, jpert.states)
    lam = jnp.asarray(1e-3)
    solves = {s: jax.jit(functools.partial(jsolve_normal_eqs, dataclasses.replace(jcfg, dense_solver=s)))(
        jeqs, jpert.state_mask, jpert.lm_mask, lam, jpert.sb_mask) for s in ("newton", "cholesky")}
    opts = {(a, s): jax.jit(functools.partial(
        joptimize_window, dataclasses.replace(jcfg, algorithm=a, dense_solver=s), jimu, jintr))(jpert)
        for a, s in (("lm", "newton"), ("dogleg", "cholesky"))}
    # the chain's last step: marginalize state 0 at the LM solution
    masks = _marg_masks(jcfg, _np_tree(jpert.obs._asdict()))
    jopt = jpert._replace(states=opts["lm", "newton"][0])
    jeqs_opt = eval_fn(jopt, jopt.states)
    jmarg = jmarginalize_system(jcfg, jeqs_opt, *map(jnp.asarray, masks), 2.0 * jeqs_opt.cost)
    return dict(jcfg=jcfg, jproblem=jproblem, truth=truth, cfg=cfg, imu=imu, intr=intr,
                problem=convert.problem_from_numpy(_np_tree(jpert), device="cpu"),
                jeqs=jeqs, solves=solves, opts=opts, masks=masks, jmarg=jmarg)


def _rel(got, want, rtol, what=""):
    """|got - want| <= rtol * max|want| (elementwise, over the whole array)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300), err_msg=what)


def _compare_trees(got: dict, want: dict, path=""):
    for k, w in want.items():
        if isinstance(w, dict):
            _compare_trees(got[k], w, f"{path}.{k}")
        elif w is not None:
            g = got[k]
            assert g.shape == w.shape and g.dtype == w.dtype, (path + "." + k, g.shape, w.shape, g.dtype, w.dtype)
            _rel(g.astype(np.float64), w.astype(np.float64), 1e-12, path + "." + k)


def _as_dict(tree):
    if hasattr(tree, "_asdict"):
        return {k: _as_dict(v) for k, v in tree._asdict().items()}
    return np.asarray(tree) if tree is not None else None


def test_build_ba_problem_matches_jax(world):
    """The port's own build equals the JAX package's draw for draw; its IMU
    links preintegrate in one batched call on rebased timestamps."""
    cfg, imu, intr, problem, truth = build_ba_problem(num_frames=4, n_landmarks=96, device="cpu")
    assert truth["num_obs"] == world["truth"]["num_obs"] == 237
    assert cfg == world["cfg"]
    want = _as_dict(world["jproblem"])
    for k in ("ext_links",):
        want.pop(k)
    for k in ("r_SC_t", "q_SC_t"):
        want["states"].pop(k)
    for k in ("r_SC_t_lin", "q_SC_t_lin"):
        want["marg"].pop(k)
    _compare_trees(convert.problem_to_numpy(problem), want)
    for key in ("r_WS", "q_WS", "sb", "landmarks"):
        np.testing.assert_array_equal(truth[key], world["truth"][key])


def test_problem_carries_across_and_back(world):
    there = convert.problem_to_numpy(world["problem"])
    again = convert.problem_to_numpy(convert.problem_from_numpy(there, device="cpu"))
    _compare_trees(again, there)
    assert world["problem"].obs.state_idx.dtype == torch.int32 and world["problem"].lm_mask.dtype == torch.bool
    f32 = convert.problem_from_numpy(there, device="cpu", dtype=torch.float32)
    assert f32.states.r_WS.dtype == torch.float32 and f32.obs.lm_idx.dtype == torch.int32


def test_extrinsics_per_state_raises(world):
    """Per-state extrinsics are ported: a per-state WindowConfig and its
    empty problem (the (S, C) extrinsics tables, their FEJ points, the
    drift-link table) cross from the JAX package with the JAX shapes, D
    grown by S*C*6; what still raises is a configuration field the port
    does not know."""
    jcfg = dataclasses.replace(world["jcfg"], extrinsics_per_state=True)
    cfg = convert.window_config_from_dict(dataclasses.asdict(jcfg))
    S, C = cfg.num_states, cfg.num_cameras
    assert cfg.extrinsics_per_state and cfg.dense_dim == jcfg.dense_dim == S * 15 + C * 6 + S * C * 6
    assert cfg.ext_link_capacity == jcfg.ext_link_capacity
    assert [cfg.ext_ps_offset(i, c) for i in range(S) for c in range(C)] == \
        [jcfg.ext_ps_offset(i, c) for i in range(S) for c in range(C)]
    from okvis_tpu.solver import empty_problem as jempty_problem

    want = _as_dict(jempty_problem(jcfg))
    got = convert.problem_to_numpy(convert.problem_from_numpy(_np_tree(jempty_problem(jcfg)), device="cpu"))
    _compare_trees(got, want)
    _compare_trees(convert.problem_to_numpy(empty_problem(cfg, device="cpu")), want)
    assert got["states"]["q_SC_t"].shape == (S, C, 4) and got["ext_links"]["sqrt_info"].shape[1:] == (6, 6)
    with pytest.raises(ValueError, match="unknown fields"):
        convert.window_config_from_dict({"num_landmarks": 3})


def test_evaluate_matches_jax(world):
    eqs = evaluate(world["cfg"], world["imu"], world["intr"], world["problem"], world["problem"].states)
    for name in NormalEqs._fields:
        _rel(getattr(eqs, name).numpy(), getattr(world["jeqs"], name), 1e-9, name)


@pytest.mark.parametrize("solver", ["newton", "cholesky"])
def test_solve_normal_eqs_matches_jax(world, solver):
    p = world["problem"]
    eqs = evaluate(world["cfg"], world["imu"], world["intr"], p, p.states)
    cfg = dataclasses.replace(world["cfg"], dense_solver=solver)
    delta_d, delta_l = solve_normal_eqs(cfg, eqs, p.state_mask, p.lm_mask,
                                        torch.tensor(1e-3, dtype=torch.float64), p.sb_mask)
    want_d, want_l = world["solves"][solver]
    _rel(delta_d.numpy(), want_d, 1e-8, "delta_d")
    _rel(delta_l.numpy(), want_l, 1e-8, "delta_l")


# LM with the default Newton-Schulz solve, and dogleg with Cholesky. The
# dogleg's Gauss-Newton step is undamped (lambda 1e-10): on this window the
# scaled system has cond 1.5e9, where 46 Newton-Schulz doublings do not reach
# the round-off floor in float64 either (the step moves by its own size
# between two BLAS libraries, in the JAX package as in the port), so the
# dogleg is held to JAX with the backward-stable Cholesky solve, its
# landmarks and cost to the eps * cond(Hs) that solve leaves.
@pytest.mark.parametrize("algorithm,solver,rtol_cost,atol_lm", [
    ("lm", "newton", 1e-8, 1e-8), ("dogleg", "cholesky", 1e-7, 1e-6)])
def test_optimize_window_matches_jax(world, algorithm, solver, rtol_cost, atol_lm):
    cfg = dataclasses.replace(world["cfg"], algorithm=algorithm, dense_solver=solver)
    states, diag = optimize_window(cfg, world["imu"], world["intr"], world["problem"])
    jstates, jdiag = world["opts"][algorithm, solver]
    np.testing.assert_array_equal(diag.accepted.numpy(), np.asarray(jdiag.accepted))
    assert diag.accepted.any()
    _rel(diag.cost_history.numpy(), jdiag.cost_history, rtol_cost, "cost_history")
    _rel(diag.final_lambda.numpy(), jdiag.final_lambda, 1e-8, "final_lambda")
    for name in states._fields:
        if getattr(states, name) is None:  # the per-state extrinsics tables of a shared-block window
            assert getattr(jstates, name) is None, name
            continue
        np.testing.assert_allclose(getattr(states, name).numpy(), np.asarray(getattr(jstates, name)), rtol=0,
                                   atol=atol_lm if name == "hp_W" else 1e-8, err_msg=name)
    if algorithm == "lm":
        _rel(diag.landmark_quality.numpy(), jdiag.landmark_quality, 1e-8, "landmark_quality")


def test_dogleg_with_newton_schulz_recovers_truth(world):
    """Dogleg with the default dense solver: the reference gates of
    tests/test_solver.py (its steps are not held to JAX's, see above)."""
    cfg = dataclasses.replace(world["cfg"], algorithm="dogleg")
    states, diag = optimize_window(cfg, world["imu"], world["intr"], world["problem"])
    truth = world["truth"]
    S = truth["r_WS"].shape[0]
    assert np.abs(states.r_WS[:S].numpy() - truth["r_WS"]).max() < 0.1
    dq = (states.q_WS[:S].numpy() * truth["q_WS"]).sum(-1)
    assert float(np.max(2 * np.arccos(np.clip(np.abs(dq), 0, 1)))) < 1e-2
    assert diag.accepted.any()


def test_optimize_recovers_truth(world):
    """The reference gates of tests/test_solver.py on the port alone."""
    cfg, p, truth = world["cfg"], world["problem"], world["truth"]
    states, diag = optimize_window(cfg, world["imu"], world["intr"], p)
    S = truth["r_WS"].shape[0]
    assert np.abs(states.r_WS[:S].numpy() - truth["r_WS"]).max() < 0.1
    dq = (states.q_WS[:S].numpy() * truth["q_WS"]).sum(-1)
    assert float(np.max(2 * np.arccos(np.clip(np.abs(dq), 0, 1)))) < 1e-2
    assert np.abs(states.speed_and_bias[:S].numpy() - truth["sb"]).max() < 0.04
    cost0 = float(evaluate(cfg, world["imu"], world["intr"], p, p.states).cost)
    assert float(diag.final_cost) < 0.1 * cost0


def test_chunked_continuation_matches_monolithic(world):
    """Re-entering the loop at the current iterate with the carried damping
    (trust0) equals one longer run."""
    cfg, imu, intr, p = world["cfg"], world["imu"], world["intr"], world["problem"]
    s_mono, d_mono = optimize_window(dataclasses.replace(cfg, max_iterations=4), imu, intr, p)
    s, d = optimize_window(dataclasses.replace(cfg, max_iterations=2), imu, intr, p)
    for _ in range(2):
        s, d = optimize_window(dataclasses.replace(cfg, max_iterations=1), imu, intr, p._replace(states=s),
                               trust0=d.final_lambda)
    for name in ("r_WS", "q_WS"):
        np.testing.assert_allclose(getattr(s, name).numpy(), getattr(s_mono, name).numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(d.final_lambda), float(d_mono.final_lambda), rtol=1e-9)


def test_landmark_quality_matches_jax_and_eigvalsh(world):
    p = world["problem"]
    H_ll = evaluate(world["cfg"], world["imu"], world["intr"], p, p.states).H_ll
    _rel(_landmark_quality(H_ll).numpy(), jlandmark_quality(jnp.asarray(H_ll.numpy())), 1e-9)
    lo, hi = _sym3x3_eig_extremes(H_ll[p.lm_mask])
    w = np.linalg.eigvalsh(H_ll[p.lm_mask].numpy())
    _rel(lo.numpy(), w[:, 0], 1e-8, "lmin")
    _rel(hi.numpy(), w[:, -1], 1e-8, "lmax")


# ---------------------------------------------------------------- dense solve


def _scaled_spd(rng, cond, n=162):
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    H = (q * np.geomspace(1.0 / cond, 1.0, n)) @ q.T
    d = np.sqrt(np.diag(H))
    return H / np.outer(d, d), rng.normal(size=n)  # unit diagonal, as in the solver


@pytest.mark.parametrize("cond", [1e2, 1e5])
def test_newton_schulz_matches_solve_and_jax(cond):
    Hs, b = _scaled_spd(np.random.default_rng(42), cond)
    x = _spd_solve_newton(torch.from_numpy(Hs), torch.from_numpy(b)).numpy()
    x_ref = np.linalg.solve(Hs, b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-8
    _rel(x, jspd_solve_newton(jnp.asarray(Hs), jnp.asarray(b)), 1e-9)


def test_newton_schulz_extreme_conditioning_needs_its_46_doublings():
    """cond 1e12: 34 doublings fail, 46 reach the round-off floor
    (tests/test_solver.py's adversarial case)."""
    Hs, b = _scaled_spd(np.random.default_rng(42), 1e12)
    x_ref = np.linalg.solve(Hs, b)
    x34 = _spd_solve_newton(torch.from_numpy(Hs), torch.from_numpy(b), iters=34).numpy()
    assert np.linalg.norm(Hs @ x34 - b) / np.linalg.norm(b) > 1e-3
    x = _spd_solve_newton(torch.from_numpy(Hs), torch.from_numpy(b)).numpy()
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-4
    assert np.linalg.norm(Hs @ x - b) / np.linalg.norm(b) < 1e-4


@pytest.mark.parametrize("scale", [1e-10, 1.0, 1.0 + 1e-10])
def test_newton_schulz_flat_spectrum(scale):
    """A flat spectrum, down to the solver's 1e-10 floor (a system whose dims
    are all fixed is (1 + 1e-10) I): exact to round-off, as in JAX."""
    n = 147
    b = np.random.default_rng(3).normal(size=n)
    Hs = scale * np.eye(n)
    x = _spd_solve_newton(torch.from_numpy(Hs), torch.from_numpy(b)).numpy()
    _rel(x, b / scale, 1e-12)
    _rel(x, jspd_solve_newton(jnp.asarray(Hs), jnp.asarray(b)), 1e-12)


# ---------------------------------------------------------------- marginalization


def test_pinv_sym_matches_jax_batched_masked_and_moore_penrose():
    rng = np.random.default_rng(42)
    A = np.stack([random_psd(rng, 3, rank=r) for r in (1, 2, 3, 5)] + [np.zeros((3, 3))])
    _rel(pinv_sym(torch.from_numpy(A)).numpy(), jpinv_sym(jnp.asarray(A)), 1e-9)
    B = random_psd(rng, 5, rank=3)
    Bi = pinv_sym(torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(B @ Bi @ B, B, atol=1e-7)
    np.testing.assert_allclose(Bi @ B @ Bi, Bi, atol=1e-7)
    C = random_psd(rng, 8)
    mask = np.asarray([True] * 5 + [False] * 3)
    Ci = pinv_sym(torch.from_numpy(C), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(Ci[:5, :5], np.linalg.inv(C[:5, :5]), atol=1e-7)
    assert not Ci[5:].any() and not Ci[:, 5:].any()
    _rel(Ci, jpinv_sym(jnp.asarray(C), jnp.asarray(mask)), 1e-9)


def _tiny():
    kw = dict(num_states=2, num_cameras=1, max_landmarks=4, max_observations=8, max_imu_links=1)
    return WindowConfig(**kw), JWindowConfig(**kw)


def _vio_system(rng, D, L):
    """A least-squares J^T J with the VIO sparsity: each row touches the
    dense block and at most one landmark (tests/test_marginalization.py)."""
    rows = []
    for lm in range(L):
        for _ in range(12):
            row = np.zeros(D + 3 * L)
            row[:D] = rng.normal(size=D) * 0.3
            row[D + 3 * lm: D + 3 * lm + 3] = rng.normal(size=3)
            rows.append(row)
    rows += [np.concatenate([rng.normal(size=D), np.zeros(3 * L)]) for _ in range(D + 5)]
    J = np.stack(rows)
    H, b = J.T @ J, J.T @ rng.normal(size=len(rows))
    blk = lambda i: slice(D + 3 * i, D + 3 * i + 3)  # noqa: E731
    return (H[:D, :D], b[:D], np.stack([H[blk(i), blk(i)] for i in range(L)]), b[D:].reshape(L, 3),
            np.stack([H[:D, blk(i)] for i in range(L)]), np.asarray(0.0)), H, b


@pytest.mark.parametrize("case", ["dense", "landmarks_then_dense"])
def test_marginalize_system_is_exact_on_quadratics(case):
    """Schur marginalization of a quadratic keeps the joint minimum over the
    kept dims; the prior has no information on the eliminated ones."""
    cfg, jcfg = _tiny()
    D, L = cfg.dense_dim, cfg.max_landmarks
    rng = np.random.default_rng(42)
    if case == "dense":
        H = random_psd(rng, D) + 0.1 * np.eye(D)
        b = rng.normal(size=D)
        eqs = (H, b, np.zeros((L, 3, 3)), np.zeros((L, 3)), np.zeros((L, D, 3)), np.asarray(0.0))
        full_H, full_b, marg_lm, c0 = H, b, np.zeros(L, bool), 1.0
    else:
        eqs, full_H, full_b = _vio_system(rng, D, L)
        marg_lm, c0 = np.ones(L, bool), 0.0
    marg = np.arange(D) < 15
    args = (marg, ~marg, marg_lm)
    out = marginalize_system(cfg, NormalEqs(*map(torch.from_numpy, eqs)), *map(torch.from_numpy, args),
                             torch.tensor(c0, dtype=torch.float64))
    Hn, bn = out.H.numpy(), out.b0.numpy()
    x_joint = np.linalg.solve(full_H, full_b)
    np.testing.assert_allclose(np.linalg.solve(Hn[15:, 15:], bn[15:]), x_joint[15:D],
                               atol=1e-8 if case == "dense" else 1e-6)
    assert not Hn[:15].any() and not bn[:15].any()
    want = jmarginalize_system(jcfg, JNormalEqs(*map(jnp.asarray, eqs)), *map(jnp.asarray, args),
                               jnp.asarray(c0))
    for name in ("H", "b0", "c0"):
        _rel(getattr(out, name).numpy(), getattr(want, name), 1e-9, name)


def test_chain_build_perturb_optimize_marginalize_matches_jax(world):
    """The estimator's step in both packages: optimize the perturbed window,
    evaluate at the solution, marginalize state 0 and the landmarks only it
    observes with c0_in = 2 cost."""
    cfg, imu, intr, p = world["cfg"], world["imu"], world["intr"], world["problem"]
    states, _ = optimize_window(cfg, imu, intr, p)
    eqs = evaluate(cfg, imu, intr, p._replace(states=states), states)
    masks = world["masks"]
    assert masks[2].any()  # some landmarks are seen by state 0 alone
    out = marginalize_system(cfg, eqs, *map(torch.from_numpy, masks), 2.0 * eqs.cost)
    for name in ("H", "b0", "c0"):
        _rel(getattr(out, name).numpy(), getattr(world["jmarg"], name), 1e-8, name)
    H = out.H.numpy()
    w = np.linalg.eigvalsh(H)
    assert w.min() >= -1e-9 * w.max() and not H[:15].any()
