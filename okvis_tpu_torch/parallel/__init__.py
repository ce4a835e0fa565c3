"""Distributed BA over a mesh of torch devices (port of okvis_tpu.parallel)."""

from .sharded_ba import (  # noqa: F401
    Mesh,
    Spec,
    make_mesh,
    make_mesh2d,
    make_sharded_optimizer,
    problem_specs,
    shard_problem,
)
