"""Sliding-window BA solver (port of okvis_tpu.solver)."""

from .assemble import NormalEqs, evaluate, marg_delta_chi  # noqa: F401
from .optimize import (  # noqa: F401
    SolveDiagnostics,
    apply_landmark_update,
    apply_update,
    dense_dim_mask,
    optimize_window,
    optimize_windows_batched,
    solve_normal_eqs,
)
from .structure import (  # noqa: F401
    BaProblem,
    ExtLinks,
    ImuLinks,
    MargPrior,
    Observations,
    PosePriors,
    SbPriors,
    WindowConfig,
    WindowStates,
    empty_problem,
)
