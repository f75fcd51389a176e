"""Stepwise (incremental / minibatch) EM on one device (counterpart of the
reference's ``parallel/sharded_em.py::make_sharded_stepwise_epoch`` and
``zero_stats_like``).

Per minibatch, with full-data scale statistics averaged over updates
(Cappe & Moulines 2009-style running averages)::

    scale   = W_total / max(W_mb, 1)                       # unbiased scale
    rho_t   = (t0 + t)^(-kappa)
    S_t     = (1 - rho_t) S_{t-1} + rho_t scale stats(minibatch_t)
    params  = normalize(S_t, theta_norm="rowsum")
    t      += 1

``loglik`` of the carry is not averaged; the monitor value of a minibatch
is ``scale * loglik`` of its pre-update state, and a group returns their
mean.  The arithmetic is the reference's float32, with ``t`` a float32
scalar tensor on the device, so a group runs with no host sync.  The
reference's ``lax.scan`` over the group is a Python loop here: one stats
call (a kernel route on CUDA) and a few elementwise launches per
minibatch.

Over a mesh (``mesh``, the reference's ``make_sharded_stepwise_epoch``):
each rank runs its restarts on its slice of every minibatch, and the
minibatch's stats and weight sum ``W_mb`` are summed over ``data`` in one
packed all_reduce, so ``rho`` and ``scale`` come from the global sums and
every rank along ``data`` holds the same states and EMA.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    Batch,
    SweepStats,
    normalize_from_stats,
)
from trigenicinteractionpredictor_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from trigenicinteractionpredictor_tpu_torch.parallel.sharded_em import all_reduce_packed


def zero_stats_like(states: ModelState) -> SweepStats:
    """The initial EMA carry (restart-stacked)."""
    S = states.theta.shape[0]
    return SweepStats(
        theta_hat=torch.zeros_like(states.theta),
        p_hat=torch.zeros_like(states.p),
        loglik=torch.zeros((S,), dtype=states.theta.dtype, device=states.theta.device),
    )


def stepwise_group(
    states: ModelState,
    ema: SweepStats,
    t: torch.Tensor,
    batches: Batch,
    degrees: torch.Tensor,
    w_total: torch.Tensor,
    stats_fn: Callable,
    kappa: float,
    t0: float,
    mesh: Optional[Mesh] = None,
) -> Tuple[ModelState, SweepStats, torch.Tensor, torch.Tensor]:
    """Run the minibatches of one dispatch group (``batches`` holds a
    leading [n_minibatches] axis) through the update above.

    Returns ``(states, ema, ll, t)``: ``ll`` [S] is the group's mean of the
    per-minibatch monitor values; ``t`` the float32 counter after the
    group.  ``w_total`` is the whole dataset's weight sum (float32 scalar
    tensor), so every group scales to full-data statistics.  ``mesh``:
    ``batches`` holds this rank's slice of each minibatch (see the module
    docstring).
    """
    group = None if mesh is None else mesh.group(DATA_AXIS)
    lls = []
    for i in range(batches.triplets.shape[0]):
        mb = Batch(batches.triplets[i], batches.ratings[i], batches.weights[i],
                   tile_rating=None if batches.tile_rating is None else batches.tile_rating[i])
        stats = stats_fn(states.theta, states.p, mb)
        w_mb = mb.weights.sum()
        if group is not None:
            *summed, w_mb = all_reduce_packed([*stats, w_mb.reshape(1)], group)
            stats, w_mb = SweepStats(*summed), w_mb[0]
        scale = w_total / torch.clamp(w_mb, min=1.0)
        rho = (t0 + t) ** (-kappa)
        ema = SweepStats(
            theta_hat=(1 - rho) * ema.theta_hat + rho * scale * stats.theta_hat,
            p_hat=(1 - rho) * ema.p_hat + rho * scale * stats.p_hat,
            loglik=ema.loglik,  # not averaged; the monitor is scale * loglik
        )
        # Row-sum normalization: averaged minibatch statistics do not keep
        # the exact row-sum == degree identity.
        states = normalize_from_stats(states, ema, degrees, theta_norm="rowsum")
        t = t + 1.0
        lls.append(scale * stats.loglik)
    return states, ema, torch.stack(lls).mean(0), t
