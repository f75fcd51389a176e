"""Sweep-kernel dispatch (counterpart of the reference's
``ops/dispatch.py::resolve_stats_fn``, reduced to the port's one kernel).

A CUDA device with the trigenic family (arity 3) and a (K, R) inside K1's
range gets the CUDA sweep kernel; everything else -- the CPU, the digenic
family (which the reference also leaves to plain code) and shapes outside
the kernel's range -- gets the plain PyTorch sweep.  The returned function
takes (thetas [S,G,K], ps [S,...,R], batch) and carries ``kernel_name``,
which the trainer records in events, checkpoints and ``FitResult``.
"""

from __future__ import annotations

from typing import Callable

import torch

from trigenicinteractionpredictor_tpu_torch.ops import em_bdr
from trigenicinteractionpredictor_tpu_torch.ops.em import em_sufficient_stats


def plain_stats(thetas, ps, batch):
    """The plain PyTorch sweep, as a stats function (any device, any arity)."""
    return em_sufficient_stats(thetas, ps, batch)


plain_stats.kernel_name = "torch"


def resolve_stats_fn(
    device, arity: int, n_genes: int, k: int, n_samples: int, n_ratings: int = 2
) -> Callable:
    """The sweep-stats function for this device and shape.  ``n_genes`` is
    part of the reference's signature; K1 has no G cap, so it does not
    narrow the choice."""
    dev = torch.device(device)
    if (
        dev.type == "cuda"
        and arity == 3
        and em_bdr.sweep_plan(k, n_ratings) is not None
        and 1 <= n_samples <= 65535
    ):
        return em_bdr.em_ensemble_stats
    return plain_stats
