"""Sweep-kernel dispatch (counterpart of the reference's
``ops/dispatch.py::resolve_stats_fn``, reduced to the port's kernels).

:func:`route` is a pure function of (device type, arity, K, R, S):

- CUDA, the trigenic family (arity 3), K <= 20: K1 (``ops/em_bdr.py``);
- CUDA, arity 3, 21 <= K <= 64: K3 (``ops/em_large_k.py``), where the
  reference runs its one-hot ensemble, grouped or single-restart kernel;
- everything else -- the CPU, the digenic family (which the reference also
  leaves to plain code) and K > 64 (where the reference runs jnp at K = 80)
  -- the plain PyTorch sweep, summed over row chunks.

The returned function takes (thetas [S,G,K], ps [S,...,R], batch) and
carries ``kernel_name``, which the trainer records in events, checkpoints
and ``FitResult``.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from trigenicinteractionpredictor_tpu_torch.ops import em_bdr, em_large_k
from trigenicinteractionpredictor_tpu_torch.ops.em import em_sufficient_stats

PLAIN_NAME = "torch"
MAX_RESTARTS = 65535  # both kernels put S on the grid's y axis


def plain_stats(thetas, ps, batch, row_chunk: int = 0):
    """The plain PyTorch sweep, as a stats function (any device, any arity);
    ``row_chunk`` > 0 sums it over chunks of that many rows."""
    return em_sufficient_stats(thetas, ps, batch, row_chunk=row_chunk)


plain_stats.kernel_name = PLAIN_NAME


def route(device_type: str, arity: int, k: int, n_ratings: int, n_samples: int) -> str:
    """The name of the sweep that runs at this device type and shape."""
    if device_type == "cuda" and arity == 3 and 1 <= n_samples <= MAX_RESTARTS:
        if em_bdr.sweep_plan(k, n_ratings) is not None:
            return em_bdr.KERNEL_NAME
        if em_large_k.sweep_plan(k, n_ratings) is not None:
            return em_large_k.KERNEL_NAME
    return PLAIN_NAME


def resolve_stats_fn(
    device, arity: int, n_genes: int, k: int, n_samples: int, n_ratings: int = 2,
    row_chunk: int = 0,
) -> Callable:
    """The sweep-stats function for this device and shape.  ``n_genes`` is
    part of the reference's signature; no port kernel has a G cap, so it
    does not narrow the choice.  ``row_chunk`` goes to the plain sweep (the
    reference's ``EngineConfig.jnp_row_chunk``); the kernels need none."""
    name = route(torch.device(device).type, arity, k, n_ratings, n_samples)
    if name == em_bdr.KERNEL_NAME:
        return em_bdr.em_ensemble_stats
    if name == em_large_k.KERNEL_NAME:
        return em_large_k.em_ensemble_stats
    fn = functools.partial(plain_stats, row_chunk=row_chunk)
    fn.kernel_name = PLAIN_NAME
    fn.row_chunk = row_chunk
    return fn
