"""Sweep-kernel dispatch (counterpart of the reference's
``ops/dispatch.py::resolve_stats_fn``, reduced to the port's kernels).

``backend`` is the reference's rule (its ``:628-633``): ``"jnp"`` (or
None / "") gives the plain sweep on any device; ``"auto"`` and
``"pallas"`` give the kernels that :func:`route` names; any other name
raises.

:func:`route` is a pure function of (device type, arity, K, R, S, G, N):

- CUDA, the trigenic family (arity 3), K <= 20 (K1's range):
  - S >= 2 and G > 4500 (the reference's bdr / plan-family crossover):
    K4 (``cuda-em-bdg``, ``ops/em_bdg.py``) while the reference's bdg
    pad-fraction rule holds at tile 256, else K5 (``cuda-em-bd-plan``,
    ``ops/em_bd.py``);
  - S = 1 and G >= 12,377: K6 (``cuda-em-large-g``, ``ops/em_large_g.py``);
  - otherwise K1 (``cuda-em-sweep``, ``ops/em_bdr.py``);
- CUDA, arity 3, 21 <= K <= 64: K3 (``ops/em_large_k.py``), where the
  reference runs its one-hot ensemble, grouped or single-restart kernel;
- everything else -- the CPU, the digenic family (which the reference also
  leaves to plain code) and K > 64 (where the reference runs jnp at K = 80)
  -- the plain PyTorch sweep, summed over row chunks.

The reference splits wide ensembles into restart groups on the plan
routes (``pallas-bdg-plan-grouped``, ``pallas-bd-plan-grouped``) because of
its VMEM; the port's kernels put restarts on the grid, so one launch per
sweep takes any S.  Rows are always static in the port (no stepwise yet).

The returned function takes (thetas [S,G,K], ps [S,...,R], batch) and
carries ``kernel_name``, which the trainer records in events, checkpoints
and ``FitResult``; a plan route's function also carries ``needs_plan`` or
``needs_g1plan`` and its block widths, and the trainer attaches the plans.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from trigenicinteractionpredictor_tpu_torch.ops import (
    em_bd,
    em_bdg,
    em_bdr,
    em_large_g,
    em_large_k,
)
from trigenicinteractionpredictor_tpu_torch.ops.em import em_sufficient_stats

PLAIN_NAME = "torch"
MAX_RESTARTS = 65535  # every kernel puts S on the grid's y axis
BACKENDS = ("auto", "pallas", "jnp")

# The reference's bdr vs plan-family crossover (its ops/dispatch.py:341).
_BDR_BD_PLAN_CROSSOVER_G = 4500
# The reference's bdg pad-fraction rule (its ops/dispatch.py:321-335): bdg
# only while its tile-padded g1 plan would add at most a quarter of the
# rows.  The port's plans have no pad rows; the rule stays as the regime
# boundary between K4 and K5, evaluated at the reference's bdg tile (256).
_BDG_WB1 = 512
_BDG_MAX_PAD_FRAC = 0.25
_BDG_TILE = 256
# The first G at which the reference leaves bdr for its large-G path at
# S = 1 (static rows, 104,858 rows, K = 10).  From the CPU probe
# resolve_stats_fn('pallas', G, K, 512, n_samples=1, n_rows=104858),
# bisected over G: pallas-bdr up to G = 12,376, pallas-large-g from 12,377
# (K = 1: 12,954; K = 5: 12,691; K = 20: 11,793 -- its VMEM model; the
# port keeps the K = 10 boundary for every K).
LARGE_G_MIN_G = 12_377


def _bdg_pad_ok(n_genes: int, tile: int, n_rows: int) -> bool:
    n_eff = n_rows or 131072  # the reference's production assumption
    pad_est = -(-n_genes // _BDG_WB1) * (tile // 2)
    return pad_est <= _BDG_MAX_PAD_FRAC * n_eff


def plain_stats(thetas, ps, batch, row_chunk: int = 0):
    """The plain PyTorch sweep, as a stats function (any device, any arity);
    ``row_chunk`` > 0 sums it over chunks of that many rows."""
    return em_sufficient_stats(thetas, ps, batch, row_chunk=row_chunk)


plain_stats.kernel_name = PLAIN_NAME


def route(device_type: str, arity: int, k: int, n_ratings: int, n_samples: int,
          n_genes: int = 0, n_rows: int = 0) -> str:
    """The name of the sweep that runs at this device type and shape
    (``n_rows`` 0: unknown, the reference's production N)."""
    if device_type == "cuda" and arity == 3 and 1 <= n_samples <= MAX_RESTARTS:
        if em_bdr.sweep_plan(k, n_ratings) is not None:
            if n_samples >= 2 and n_genes > _BDR_BD_PLAN_CROSSOVER_G:
                if (_bdg_pad_ok(n_genes, _BDG_TILE, n_rows)
                        and em_bdg.bdg_plan(k, n_ratings) is not None):
                    return em_bdg.KERNEL_NAME
                return em_bd.KERNEL_NAME
            if n_samples == 1 and n_genes >= LARGE_G_MIN_G:
                return em_large_g.KERNEL_NAME
            return em_bdr.KERNEL_NAME
        if em_large_k.sweep_plan(k, n_ratings) is not None:
            return em_large_k.KERNEL_NAME
    return PLAIN_NAME


def stats_fn_for(name: str, k: int = 0, n_ratings: int = 2, row_chunk: int = 0,
                 wb: int = em_bd.DEFAULT_WB) -> Callable:
    """The stats function of a route name (``wb``: the scatter plan's gene
    block width; the bdg block wb1 follows from K and R)."""
    if name == em_bdr.KERNEL_NAME:
        return em_bdr.em_ensemble_stats
    if name == em_large_k.KERNEL_NAME:
        return em_large_k.em_ensemble_stats
    if name == PLAIN_NAME:
        fn = functools.partial(plain_stats, row_chunk=row_chunk)
        fn.row_chunk = row_chunk
    elif name == em_bdg.KERNEL_NAME:
        wb1 = em_bdg.bdg_plan(k, n_ratings)[1]
        fn = functools.partial(em_bdg.bdg_em_ensemble_stats, wb1=wb1, wb=wb)
        fn.wb, fn.wb1 = wb, wb1
        fn.needs_g1plan = True  # g1 row order + 2-position scatter plan
    elif name in (em_bd.KERNEL_NAME, em_large_g.KERNEL_NAME):
        impl = (em_bd.bd_em_ensemble_stats if name == em_bd.KERNEL_NAME
                else em_large_g.large_g_ensemble_stats)
        fn = functools.partial(impl, wb=wb)
        fn.wb = wb
        fn.needs_plan = True    # 3-position scatter plan
    else:
        raise ValueError(f"unknown sweep route {name!r}")
    fn.kernel_name = name
    return fn


def resolve_stats_fn(
    device, arity: int, n_genes: int, k: int, n_samples: int, n_ratings: int = 2,
    row_chunk: int = 0, backend: str = "auto", n_rows: int = 0,
) -> Callable:
    """The sweep-stats function for this backend, device and shape.
    ``row_chunk`` goes to the plain sweep (the reference's
    ``EngineConfig.jnp_row_chunk``); the kernels need none."""
    if backend not in (None, "", *BACKENDS):
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")
    if backend in (None, "", "jnp"):
        name = PLAIN_NAME
    else:
        name = route(torch.device(device).type, arity, k, n_ratings, n_samples,
                     n_genes=n_genes, n_rows=n_rows)
    return stats_fn_for(name, k, n_ratings, row_chunk)
