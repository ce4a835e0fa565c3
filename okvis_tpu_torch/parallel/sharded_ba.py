"""Distributed sliding-window BA: the landmark and observation tables
sharded over a mesh of devices (port of okvis_tpu.parallel.sharded_ba).

The design is the JAX package's:

- mesh axis "map": the landmark table (L) and the observation table (O)
  are split into n contiguous blocks, one a shard; shard_problem regroups
  the observations so that each landmark's observations lie in its
  shard's block, with shard-local landmark indices;
- each shard evaluates its reprojection factors: its landmark blocks H_ll,
  b_l and W stay with it, and its partial dense H, b and cost are summed
  over the shards (JAX's psum);
- the IMU, prior and marginal factors are small and dense: they are
  evaluated once, on the replicated states;
- the landmark Schur complement is shard-local and summed, the damped,
  Jacobi-scaled dense solve is replicated, and the landmark
  back-substitution is shard-local.

A mesh is an explicit tuple of torch devices, one for each shard this
process holds, in shard order. A device may repeat: n shards on one card
are the counterpart of the JAX tests' virtual CPU mesh. The shards that
sit on one device are evaluated as one batch over a leading shard axis
(torch.func.vmap of the reprojection evaluation). That is the same
arithmetic for each shard, with launches that do not grow with n. Sums over
shards run in a fixed shard order with no atomics, so reruns give the same
bits. The "host" axis of make_mesh2d crosses processes through
torch.distributed's all_reduce when the process group spans them. As in
JAX, the innermost axis is summed first: the map axis inside the process,
then the host axis across processes. Between processes on one card the
group must be gloo, which takes CUDA tensors (NCCL refuses two ranks on one
GPU).

Copied from the JAX package as it is: the sharded step is LM whatever
cfg.algorithm says, it carries no landmark quality (the Estimator then
runs its separate pass), and it takes no warm-started damping (trust0).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..device import resolve_device
from ..imu.preintegration import ImuParams
from ..solver.assemble import evaluate_dense_factors, evaluate_reprojection
from ..solver.optimize import (
    _select,
    apply_landmark_update,
    apply_update,
    back_substitute,
    damp_dense,
    damped_landmark_inverse,
    dense_dim_mask,
    solve_reduced,
)
from ..solver.structure import BaProblem, Observations, WindowConfig, empty_problem


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh. `devices` holds this process's shards in shard order,
    `axis_names` the mesh's axes, and `shape` each axis's size over every
    process. When `process_axis` is set, that axis (the first) crosses
    processes, and this process holds the row of its torch.distributed
    rank."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    process_axis: Optional[str] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return 0 if self.process_axis is None else torch.distributed.get_rank() * len(self.devices)


def _device(d) -> torch.device:
    d = resolve_device(d)
    return torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d


def make_mesh(n_devices: int = None, axis: str = "map", devices=None) -> Mesh:
    """A one-axis mesh of n_devices shards. Without `devices` it takes the
    first n_devices CUDA cards, distinct, and raises when fewer are visible
    (n_devices None: all of them); with no card it is a virtual mesh of
    n_devices CPU shards (None: one). `devices` lists the shards' devices
    explicitly, and a device may repeat (several shards on one card)."""
    if devices is None:
        if torch.cuda.is_available():
            avail = torch.cuda.device_count()
            if n_devices is not None and avail < n_devices:
                raise ValueError(
                    f"requested a {n_devices}-device mesh but only {avail} CUDA device(s) are visible "
                    f"(pass devices=[...] with a repeated device for several shards on one card)")
            devices = [torch.device("cuda", i) for i in range(n_devices or avail)]
        else:
            devices = ["cpu"] * (n_devices or 1)
    devices = tuple(_device(d) for d in devices)
    if n_devices is not None and len(devices) != n_devices:
        raise ValueError(f"a {n_devices}-device mesh given {len(devices)} devices")
    return Mesh(devices=devices, axis_names=(axis,), shape={axis: len(devices)})


def make_mesh2d(n_hosts: int, devices_per_host: int, devices=None) -> Mesh:
    """A ("host", "map") mesh. The map axis is devices_per_host shards of
    one process; only the already reduced dense system crosses the host
    axis, and the landmark tables never leave their host.

    When a torch.distributed group of n_hosts processes is up, the host
    axis crosses the processes (through all_reduce) and this process holds
    the map row of its rank, on `devices` (devices_per_host of them; by
    default make_mesh's). Otherwise every shard is this process's, and
    `devices` lists all n_hosts * devices_per_host of them."""
    dist = torch.distributed
    shape = {"host": n_hosts, "map": devices_per_host}
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_world_size() != n_hosts:
            raise ValueError(f"a {n_hosts}-host mesh in a group of {dist.get_world_size()} processes")
        local = make_mesh(devices_per_host, devices=devices).devices
        return Mesh(devices=local, axis_names=("host", "map"), shape=shape, process_axis="host")
    local = make_mesh(n_hosts * devices_per_host, devices=devices).devices
    return Mesh(devices=local, axis_names=("host", "map"), shape=shape)


def _ordered_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` in index order, one add a term (no atomics)."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _psum_hier(parts: List[torch.Tensor], mesh: Mesh, home: torch.device) -> torch.Tensor:
    """The sum over every shard of the mesh of per-shard values: `parts`
    holds this process's shards, one (n_group, ...) tensor for each run of
    shards on one device. Innermost (last) axis first, as the JAX package's
    hierarchical psum; an axis that crosses processes is summed by
    torch.distributed.all_reduce."""
    x = torch.cat([p.to(home) for p in parts]) if len(parts) > 1 else parts[0].to(home)
    sizes = [1 if a == mesh.process_axis else mesh.shape[a] for a in mesh.axis_names]
    x = x.reshape(*sizes, *x.shape[1:])
    for dim in reversed(range(len(sizes))):
        x = _ordered_sum(x, dim)
    if mesh.process_axis is not None:
        x = x.contiguous()
        torch.distributed.all_reduce(x)
    return x


@dataclasses.dataclass(frozen=True)
class Spec:
    """The mesh axes a leaf's leading dimension is split over; () for a
    replicated leaf (JAX's PartitionSpec of a BaProblem leaf)."""

    axes: Tuple[str, ...] = ()


def _axes(axis) -> Tuple[str, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def problem_specs(cfg: WindowConfig, axis="map") -> BaProblem:
    """A BaProblem of Specs: the observation table, lm_mask and states.hp_W
    are split over `axis` (a name, or a tuple such as ("host", "map")) on
    their leading dimension; every other leaf is replicated."""
    rep, sh = Spec(), Spec(_axes(axis))
    p = pytree.tree_map(lambda x: None if x is None else rep, empty_problem(cfg, torch.float32, "cpu"))
    return p._replace(states=p.states._replace(hp_W=sh), lm_mask=sh,
                      obs=Observations(*(sh for _ in Observations._fields)))


def shard_problem(problem: BaProblem, n_shards: int, on_overflow: str = "drop") -> BaProblem:
    """Regroup the observation table so that each landmark's observations
    lie in its shard's block, on the host in numpy (the JAX package's,
    array for array).

    Landmark slot l belongs to shard l // (L/n). The observations are
    regrouped so that shard s's block [s·O/n, (s+1)·O/n) references only
    shard s's landmarks, and lm_idx becomes shard-local. Vectorized: a
    stable argsort and cumulative ranks within each shard.

    on_overflow: a shard's block holds O/n observations. When one shard's
    landmarks have more, 'drop' sheds the excess with a warning (the
    pipeline's drop-on-full policy) and 'raise' raises (strict mode for
    tests)."""
    L = problem.lm_mask.shape[0]
    O = problem.obs.mask.shape[0]
    if L % n_shards or O % n_shards:
        raise ValueError(f"capacities L = {L}, O = {O} not divisible by {n_shards} shards")
    Ls, Os = L // n_shards, O // n_shards
    obs = problem.obs
    lm_idx = obs.lm_idx.cpu().numpy()
    mask = obs.mask.cpu().numpy()

    idx = np.nonzero(mask)[0]
    shard = lm_idx[idx] // Ls
    order = np.argsort(shard, kind="stable")
    idx, shard = idx[order], shard[order]
    counts = np.bincount(shard, minlength=n_shards)
    offsets = np.concatenate([[0], np.cumsum(counts)])[:-1]
    within = np.arange(len(idx)) - offsets[shard]  # rank inside its own shard
    keep = within < Os
    if not keep.all():
        n_drop = int((~keep).sum())
        if on_overflow == "raise":
            raise RuntimeError(f"shard observation block overflow ({n_drop} over capacity {Os}/shard)")
        logging.getLogger("okvis_tpu_torch").warning(
            "distributed BA: shedding %d observation(s) over the %d/shard block capacity", n_drop, Os)
        idx, shard, within = idx[keep], shard[keep], within[keep]
    dst = shard * Os + within

    new = {}
    for k in obs._fields:
        src = getattr(obs, k).cpu().numpy()
        out = np.zeros_like(src)
        out[dst] = src[idx]
        new[k] = out
    new["lm_idx"][dst] = lm_idx[idx] - shard * Ls  # shard-local index
    new["mask"][:] = False
    new["mask"][dst] = True
    return problem._replace(obs=Observations(**{k: torch.from_numpy(v).to(obs.mask.device) for k, v in new.items()}))


class _ShardedEqs(NamedTuple):
    """Normal equations of a sharded iterate: the dense system and cost,
    reduced and on the home device, and each device group's landmark blocks
    (n_group, L/n, ...)."""

    H_dd: torch.Tensor
    b_d: torch.Tensor
    cost: torch.Tensor
    H_ll: Tuple[torch.Tensor, ...]
    b_l: Tuple[torch.Tensor, ...]
    W: Tuple[torch.Tensor, ...]


def _groups(devices: Tuple[torch.device, ...]) -> List[Tuple[torch.device, int, int]]:
    """Runs of equal devices: (device, first local shard, count)."""
    out = []
    for i, d in enumerate(devices):
        if out and out[-1][0] == d:
            out[-1] = (d, out[-1][1], out[-1][2] + 1)
        else:
            out.append((d, i, 1))
    return out


def _to(tree, device):
    return pytree.tree_map(lambda x: None if x is None else x.to(device), tree)


def make_sharded_optimizer(cfg: WindowConfig, imu_params: ImuParams, intrinsics: List[torch.Tensor],
                           mesh: Mesh, axis="map"):
    """The sharded optimize step: a problem laid out by shard_problem
    (shard-local lm_idx, on any device) -> (states, (final cost, cost
    history, accepted, final lambda)).

    `axis` names every axis of the mesh (a tuple for make_mesh2d's). The
    replicated results lie on the mesh's first device. hp_W holds this
    process's shards' landmark rows: the whole table unless the mesh
    crosses processes. cfg.max_iterations LM iterations, each with one
    sharded evaluation (one reduction round) at the candidate: the
    equations of the current iterate ride the carry."""
    axes = _axes(axis)
    if set(axes) != set(mesh.axis_names):
        raise ValueError(f"axis {axis} must name every axis of the mesh {mesh.axis_names}")
    n = mesh.size
    if cfg.max_landmarks % n or cfg.max_observations % n:
        raise ValueError(f"capacities L = {cfg.max_landmarks}, O = {cfg.max_observations} "
                         f"not divisible by the mesh size {n}")
    cfg_local = dataclasses.replace(cfg, max_landmarks=cfg.max_landmarks // n,
                                    max_observations=cfg.max_observations // n)
    specs = problem_specs(cfg, axes)
    home = mesh.devices[0]
    groups = _groups(mesh.devices)
    imu_home = ImuParams(*(x.to(home) if isinstance(x, torch.Tensor) else x for x in imu_params))
    D = cfg.dense_dim

    def reprojection(intr):
        def one(obs, hp, dense):
            return evaluate_reprojection(cfg_local, intr, obs, dense._replace(hp_W=hp))
        return torch.func.vmap(one, in_dims=(0, 0, None))

    group_eval = [reprojection([i.to(dev) for i in intrinsics]) for dev, _, _ in groups]

    def split(problem: BaProblem):
        """The replicated leaves on the home device (sharded ones None), and
        each device group's blocks (n_group, L/n or O/n, ...)."""
        rep = pytree.tree_map(lambda x, sp: None if x is None or sp.axes else x.to(home), problem, specs)
        first = mesh.first_shard

        def blocks(x, dev, s, c):
            blk = x.shape[0] // n
            return x[(first + s) * blk: (first + s + c) * blk].reshape(c, blk, *x.shape[1:]).to(dev)

        shards = [(Observations(*(blocks(x, dev, s, c) for x in problem.obs)),
                   blocks(problem.states.hp_W, dev, s, c), blocks(problem.lm_mask, dev, s, c))
                  for dev, s, c in groups]
        return rep, shards

    def sharded_evaluate(rep, shards, dense, hps) -> _ShardedEqs:
        partial, H_ll, b_l, W = [], [], [], []
        for (dev, _, _), fn, (obs, _, _), hp in zip(groups, group_eval, shards, hps):
            H, b, H_ll_g, b_l_g, W_g, cost = fn(obs, hp, _to(dense, dev))
            partial.append(torch.cat([H.flatten(1), b, cost[:, None]], dim=1))
            H_ll.append(H_ll_g)
            b_l.append(b_l_g)
            W.append(W_g)
        red = _psum_hier(partial, mesh, home)
        H_dense, b_dense, cost_dense = evaluate_dense_factors(cfg, imu_home, rep, dense)
        return _ShardedEqs(H_dd=red[: D * D].reshape(D, D) + H_dense, b_d=red[D * D: D * D + D] + b_dense,
                           cost=red[D * D + D] + cost_dense, H_ll=tuple(H_ll), b_l=tuple(b_l), W=tuple(W))

    def sharded_solve(rep, shards, eqs: _ShardedEqs, lam):
        """The damped Schur solve with the landmark elimination shard-local
        and the reduced system summed over the shards (solve_normal_eqs)."""
        partial, Hl_inv = [], []
        for (_, _, lm), H_ll, b_l, W in zip(shards, eqs.H_ll, eqs.b_l, eqs.W):
            inv = damped_landmark_inverse(H_ll, lam.to(H_ll.device), lm)
            WH = W @ inv  # (n_group, L/n, D, 3)
            partial.append(torch.cat([torch.einsum("sldb,sleb->sde", WH, W).flatten(1),
                                      torch.einsum("sldb,slb->sd", WH, b_l)], dim=1))
            Hl_inv.append(inv)
        red = _psum_hier(partial, mesh, home)
        H_red = damp_dense(eqs.H_dd, lam) - red[: D * D].reshape(D, D)
        b_red = eqs.b_d - red[D * D:]
        delta_d = solve_reduced(cfg, H_red, b_red, dense_dim_mask(cfg, rep.state_mask, rep.sb_mask))
        deltas_l = [back_substitute(inv, b_l, W, delta_d.to(W.device))
                    for inv, b_l, W in zip(Hl_inv, eqs.b_l, eqs.W)]
        return delta_d, deltas_l

    def select(accept, a: _ShardedEqs, b: _ShardedEqs) -> _ShardedEqs:
        return _ShardedEqs(*(torch.where(accept, x, y) for x, y in zip(a[:3], b[:3])),
                           *(tuple(torch.where(accept.to(x.device), x, y) for x, y in zip(xs, ys))
                             for xs, ys in zip(a[3:], b[3:])))

    def step(problem: BaProblem):
        rep, shards = split(problem)
        dense = rep.states  # hp_W None: the landmark rows ride `hps`
        hps = [hp for _, hp, _ in shards]
        eqs = sharded_evaluate(rep, shards, dense, hps)
        lam = torch.full((), cfg.init_lambda, dtype=dense.r_WS.dtype, device=home)
        hist, acc = [], []
        for _ in range(cfg.max_iterations):
            delta_d, deltas_l = sharded_solve(rep, shards, eqs, lam)
            cand = apply_update(cfg, dense, delta_d, None, rep.state_mask, None)
            cand_hps = [apply_landmark_update(hp, dl, lm) for hp, dl, (_, _, lm) in zip(hps, deltas_l, shards)]
            eqs_cand = sharded_evaluate(rep, shards, cand, cand_hps)
            accept = eqs_cand.cost < eqs.cost
            dense = _select(accept, cand, dense)
            hps = [torch.where(accept.to(c.device), c, hp) for c, hp in zip(cand_hps, hps)]
            eqs = select(accept, eqs_cand, eqs)
            lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-10, 1e8)
            hist.append(eqs.cost)
            acc.append(accept)
        hp_W = torch.cat([hp.to(home).reshape(-1, hp.shape[-1]) for hp in hps])
        return dense._replace(hp_W=hp_W), (eqs.cost, torch.stack(hist), torch.stack(acc), lam)

    return step
