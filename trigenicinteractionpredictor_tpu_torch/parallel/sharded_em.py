"""The data- and ensemble-parallel EM sweep over a mesh of ranks
(counterpart of the reference's ``parallel/sharded_em.py``).

Each rank holds a contiguous range of the triplet rows (:func:`shard_rows`,
as ``P(DATA_AXIS)`` splits them) and a contiguous block of ``S //
ensemble`` restarts (:func:`shard_ensemble`).  A sweep runs the stats
function -- the dispatched kernel on CUDA -- on the rank's rows and
restarts, sums the three :class:`SweepStats` fields over ``data`` in one
``all_reduce`` of a packed flat buffer, and normalizes with the global
degrees: the reference's ``local_step``.  Every rank along ``data`` then
holds the same states, since each normalizes the same sums.  The
``ensemble`` axis needs no communication until :func:`gather_states` /
:func:`gather_loglik` rebuild the full ``[S, ...]`` arrays on every rank.

A gather is an ``all_reduce`` of disjoint blocks (each rank writes its
block into zeros): exact, since adding zeros changes no value, and it
asks the backend for nothing but ``all_reduce``, which gloo runs on CUDA
tensors too.  Without process groups (:func:`mesh.single_device_mesh`)
every collective is skipped and the sweep is the one-process sweep.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    Batch,
    SweepStats,
    em_sufficient_stats,
    log_likelihood,
    normalize_from_stats,
)
from trigenicinteractionpredictor_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ENSEMBLE_AXIS,
    Mesh,
)


def shard_rows(n_rows: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's row range [lo, hi) along ``data``: ceil(n / data) rows a
    rank, the last range shorter (the reference pads instead; weight-0
    rows are inert, so the sums are the same)."""
    per = -(-n_rows // mesh.shape[DATA_AXIS])
    lo = min(mesh.index(DATA_AXIS) * per, n_rows)
    return lo, min(lo + per, n_rows)


def block(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` over ``axis``."""
    n = x.shape[dim] // mesh.shape[axis]
    return x.narrow(dim, mesh.index(axis) * n, n).contiguous()


def shard_ensemble(states: ModelState, mesh: Mesh) -> ModelState:
    """This rank's block of ``S // ensemble`` restarts."""
    return ModelState(theta=block(states.theta, mesh, ENSEMBLE_AXIS),
                      p=block(states.p, mesh, ENSEMBLE_AXIS))


def all_reduce_packed(tensors: Sequence[torch.Tensor], group) -> list:
    """Sum ``tensors`` over ``group`` in one ``all_reduce`` of a flat buffer
    (no group: the tensors as they are)."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def gather_blocks(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The blocks of every rank along ``axis`` joined on ``dim``, on every
    rank: an all_reduce of disjoint blocks (see the module docstring)."""
    group = mesh.group(axis)
    if group is None:
        return x
    size, n = mesh.shape[axis], x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    full = x.new_zeros(shape)
    full.narrow(dim, mesh.index(axis) * n, n).copy_(x)
    dist.all_reduce(full, group=group)
    return full


def gather_states(states: ModelState, mesh: Mesh) -> ModelState:
    """The full ``[S, ...]`` states on every rank."""
    return ModelState(theta=gather_blocks(states.theta, mesh, ENSEMBLE_AXIS),
                      p=gather_blocks(states.p, mesh, ENSEMBLE_AXIS))


def gather_loglik(ll: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The per-restart ``[S]`` loglik on every rank."""
    return gather_blocks(ll, mesh, ENSEMBLE_AXIS)


def any_rank(flag: bool, mesh: Mesh, device) -> bool:
    """True on every rank when ``flag`` is true on any rank of the mesh (a
    tensor on ``device``, which NCCL needs): the ranks take one decision
    (early stop), so none waits alone in a later collective."""
    if not mesh.distributed:
        return flag
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t)
    return bool(t.item() > 0)


def reduce_stats(stats: SweepStats, mesh: Mesh) -> SweepStats:
    """The stats summed over ``data``: one all_reduce of theta_hat, p_hat
    and loglik packed into one buffer."""
    return SweepStats(*all_reduce_packed(stats, mesh.group(DATA_AXIS)))


def powered(states: ModelState, beta: float, out: Optional[Tuple] = None) -> ModelState:
    """(theta^beta, p^beta), the annealed E-step's parameters, written into
    ``out`` (two buffers shaped like the states) when given."""
    th, pp = out if out is not None else (torch.empty_like(states.theta),
                                          torch.empty_like(states.p))
    torch.pow(states.theta, beta, out=th)
    torch.pow(states.p, beta, out=pp)
    return ModelState(theta=th, p=pp)


def sharded_step(
    states: ModelState,
    batch: Batch,
    degrees: torch.Tensor,
    mesh: Mesh,
    stats_fn: Callable = em_sufficient_stats,
    beta: Optional[float] = None,
    buffers: Optional[Tuple] = None,
) -> Tuple[ModelState, torch.Tensor]:
    """One EM sweep of this rank's restarts over the mesh's rows: ``(new
    states, loglik [S_local] of the pre-update states)``.

    ``beta`` runs the annealed sweep: the stats of (theta^beta, p^beta)
    (into ``buffers`` when given), normalized over the unpowered states,
    so zero-mass cells and untrained genes keep the unpowered carry.
    """
    src = states if beta is None else powered(states, beta, buffers)
    stats = reduce_stats(stats_fn(src.theta, src.p, batch), mesh)
    return normalize_from_stats(states, stats, degrees), stats.loglik


def sharded_multi_step(
    states: ModelState,
    batch: Batch,
    degrees: torch.Tensor,
    mesh: Mesh,
    n_inner: int,
    stats_fn: Callable = em_sufficient_stats,
    betas: Optional[Sequence[float]] = None,
) -> Tuple[ModelState, torch.Tensor]:
    """``n_inner`` chained sweeps: ``(states, ll_hist [n_inner, S_local])``,
    row i the L of the states before sweep i.  ``betas`` (one a sweep)
    anneals them."""
    buffers = None if betas is None else (torch.empty_like(states.theta),
                                          torch.empty_like(states.p))
    lls = []
    for i in range(n_inner):
        states, ll = sharded_step(states, batch, degrees, mesh, stats_fn,
                                  None if betas is None else float(betas[i]), buffers)
        lls.append(ll)
    return states, torch.stack(lls)


def sharded_likelihood(states: ModelState, batch: Batch, mesh: Mesh,
                       row_chunk: int = 0) -> torch.Tensor:
    """Per-restart log-likelihood ``[S_local]`` over every rank's rows."""
    ll = log_likelihood(states, batch, row_chunk=row_chunk)
    return all_reduce_packed([ll], mesh.group(DATA_AXIS))[0]
