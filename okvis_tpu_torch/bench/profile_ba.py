"""The BA optimize step's stages alone on the card (port of scripts/profile_ba.py).

On the EuRoC window (float32): the full optimize (3 LM iterations), evaluate
(all factors) and its reprojection and dense-factor halves, the Schur solve
(solve_normal_eqs), the Newton-Schulz dense solve on the Jacobi-scaled
system H_dd + 10 I, apply_update, the accept/reject select of the states
and normal equations, and the landmark quality. Each stage's summed kernel
ms a call (profiled calls, utils.profiling) and wall ms a call (the card
waited for). Then the attribution: 3 x (evaluate + solve + apply + select)
+ evaluate + quality against the full optimize.

    python -m okvis_tpu_torch.bench.profile_ba [--reps 20] [--device cpu]
"""

from __future__ import annotations

import torch

from . import common


def newton_schulz_call(cfg, eqs):
    """The Newton-Schulz dense solve alone, on the window's Jacobi-scaled
    H_dd + 10 I and its right-hand side, as a call."""
    from ..solver.optimize import _spd_solve_newton

    Hs = eqs.H_dd + 10.0 * torch.eye(cfg.dense_dim, dtype=eqs.H_dd.dtype, device=eqs.H_dd.device)
    s = torch.sqrt(torch.clamp(torch.diagonal(Hs), min=1e-12))
    Hs = Hs / (s[:, None] * s[None, :])
    rhs = eqs.b_d / s
    return lambda: _spd_solve_newton(Hs, rhs)


def stages(cfg, imu, intr, problem) -> dict:
    """name -> call of every profiled stage on the window."""
    from ..solver import apply_update, evaluate, optimize_window, solve_normal_eqs
    from ..solver.assemble import evaluate_dense_factors, evaluate_reprojection
    from ..solver.optimize import _landmark_quality, _select

    states = problem.states
    eqs = evaluate(cfg, imu, intr, problem, states)
    lam = torch.tensor(1e-4, dtype=eqs.H_dd.dtype, device=eqs.H_dd.device)
    solve = lambda: solve_normal_eqs(cfg, eqs, problem.state_mask, problem.lm_mask, lam, problem.sb_mask)  # noqa: E731
    delta_d, delta_l = solve()
    acc = torch.tensor(True, device=eqs.H_dd.device)
    other_states = type(states)(*(None if x is None else x + 1 for x in states))
    other_eqs = type(eqs)(*(None if x is None else x + 1 for x in eqs))
    return {
        "full optimize (3 LM iters)": lambda: optimize_window(cfg, imu, intr, problem),
        "evaluate (all factors)": lambda: evaluate(cfg, imu, intr, problem, states),
        "evaluate_reprojection": lambda: evaluate_reprojection(cfg, intr, problem.obs, states),
        "evaluate_dense_factors": lambda: evaluate_dense_factors(cfg, imu, problem, states),
        "solve_normal_eqs (Schur)": solve,
        "Newton-Schulz dense solve": newton_schulz_call(cfg, eqs),
        "apply_update": lambda: apply_update(cfg, states, delta_d, delta_l, problem.state_mask, problem.lm_mask),
        "accept/reject select (states+eqs)": lambda: (_select(acc, states, other_states),
                                                      _select(acc, eqs, other_eqs)),
        "landmark quality (3x3 extremes)": lambda: _landmark_quality(eqs.H_ll),
    }


def run(reps: int = 20, device=None, dtype=torch.float32, verbose: bool = True) -> dict:
    dev = common.resolve_device(device)
    window = common.build_window(dev, dtype)
    rows = {}
    for name, fn in stages(*window[:4]).items():
        fn()
        k = common.kernel_ms(fn, dev, max(1, reps // 5))
        rows[name] = dict(wall_ms=common.wall_ms(fn, dev, reps), kernel_ms=None if k is None else k["kernel_ms"],
                          launches=None if k is None else k["launches"])
        if verbose:
            print(f"{name:40s} {rows[name]['wall_ms']:10.3f} ms wall  {rows[name]['kernel_ms']} ms kernels", flush=True)
    key = "kernel_ms" if dev.type == "cuda" else "wall_ms"
    t = {n: r[key] for n, r in rows.items()}
    per_iter = (t["evaluate (all factors)"] + t["solve_normal_eqs (Schur)"] + t["apply_update"]
                + t["accept/reject select (states+eqs)"])
    attributed = 3 * per_iter + t["evaluate (all factors)"] + t["landmark quality (3x3 extremes)"]
    return dict(metric="ba_stage_profile", device=common.device_name(dev), dtype=str(dtype).split(".")[-1],
                stages=rows, attribution_by=key, attributed_ms=attributed,
                full_ms=t["full optimize (3 LM iters)"],
                attributed_share=attributed / t["full optimize (3 LM iters)"])


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    common.emit(run(args.reps, args.device), args.out)


if __name__ == "__main__":
    main()
