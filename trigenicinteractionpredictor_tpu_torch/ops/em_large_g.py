"""K6: the large-G sweep at any ensemble width, and the scatter plan of
every large-G route (counterpart of the reference's
``ops/pallas_em_large.py``: ``ScatterPlan``, ``make_scatter_plan``,
``_pallas_stats_large`` and ``large_g_ensemble_stats``).

No buffer of the sweep scales with G: an E-step writes per-row position
marginals (streams), and ``plan_scatter`` segment-sums them into
theta_hat along a host plan.  The reference runs a per-restart E-step
kernel here and a block-diagonal one on the bd-plan route; on the card one
E-step kernel (``csrc/em_sweep.cu`` in its streams form) and one scatter kernel
(``csrc/plan_scatter.cu``) serve both, so :func:`large_g_ensemble_stats`
is ``ops/em_bd.py``'s sweep under its own route name (the reference's
dispatch gives this route S = 1 at G >= 12,377 and K = 10).

The plan is the reference's without its padding: a stable sort of the
positional gene-id streams by gene id, and CSR offsets of the sorted slots
per ``wb``-gene block.  The reference pads every block's run to a whole
tile and lists a block per tile (``pallas_em_large.py:109-118``); the
port's kernels need neither.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.ops import em_bd
from trigenicinteractionpredictor_tpu_torch.ops.em import Batch, SweepStats

KERNEL_NAME = "cuda-em-large-g"
DEFAULT_WB = em_bd.DEFAULT_WB


class ScatterPlan(NamedTuple):
    """Host-side scatter plan (see :func:`make_scatter_plan`)."""

    perm: np.ndarray     # int32 [P*B] stream slots (p, b) -> p*B + b, gene-sorted
    lid: np.ndarray      # int32 [P*B] gene - block * wb of each sorted slot
    offsets: np.ndarray  # int32 [Q+1] CSR: block q holds sorted slots [off[q], off[q+1])
    n_blocks: int        # Q = ceil(G / wb)
    wb: int


def _check_ids(genes: np.ndarray, n_genes: int) -> None:
    if genes.size and (genes.min() < 0 or genes.max() >= n_genes):
        raise ValueError(f"a plan needs gene ids in [0, {n_genes})")


def make_scatter_plan(triplets, n_genes: int, wb: int = DEFAULT_WB,
                      positions=None) -> ScatterPlan:
    """Sort the positional gene-id streams by gene id (stably), with CSR
    offsets per ``wb``-gene block.

    ``positions`` (default: every column) restricts the plan to those
    streams: the bdg route scatters positions (1, 2) and keeps position 0
    in its E-step.  Slot (p, b) -> p*B + b enumerates the chosen positions
    in order, as the E-step stacks its streams.
    """
    triplets = np.asarray(triplets)
    cols = list(range(triplets.shape[1])) if positions is None else list(positions)
    stream_g = triplets[:, cols].T.reshape(-1)
    _check_ids(stream_g, n_genes)
    order = np.argsort(stream_g, kind="stable")
    g_sorted = stream_g[order]
    n_blocks = -(-n_genes // wb)
    offsets = np.zeros(n_blocks + 1, np.int64)
    np.cumsum(np.bincount(g_sorted // wb, minlength=n_blocks), out=offsets[1:])
    return ScatterPlan(
        perm=order.astype(np.int32),
        lid=(g_sorted % wb).astype(np.int32),
        offsets=offsets.astype(np.int32),
        n_blocks=n_blocks,
        wb=wb,
    )


def device_scatter_plan(genes: torch.Tensor, n_genes: int, wb: int = DEFAULT_WB):
    """:func:`make_scatter_plan` on the rows' device, as the tensors
    ``plan_scatter`` takes (perm, lid, offsets; int32), for the slots whose
    gene ids are ``genes`` (int [P*B], slot p*B + b).  A slot whose id is
    outside [0, n_genes) adds to no gene: it sorts last, past the plan's
    genes, and its local id makes its gene n_genes, which the scatter
    skips.  A stable sort, so the same ids give the same plan on every
    run."""
    g = genes.to(torch.int32)  # 32-bit keys: half the radix sort's passes of 64-bit ones
    key = torch.where((g >= 0) & (g < n_genes), g, torch.full_like(g, n_genes))
    key, perm = torch.sort(key, stable=True)
    n_blocks = -(-n_genes // wb)
    offsets = torch.zeros(n_blocks + 1, dtype=torch.int32, device=g.device)
    offsets[1:] = torch.cumsum(torch.bincount(key // wb, minlength=n_blocks + 1)[:n_blocks], 0)
    lid = torch.where(key < n_genes, key % wb,
                      torch.full_like(key, n_genes - (n_blocks - 1) * wb))
    return perm.to(torch.int32), lid, offsets


def large_g_ensemble_stats(thetas, ps, batch: Batch, wb: int = DEFAULT_WB) -> SweepStats:
    """One whole-ensemble sweep at any G: ``ops/em_bd.py``'s E-step streams
    and plan scatter.  ``batch`` carries a 3-position scatter plan of
    ``wb``-gene blocks for exactly its rows."""
    return em_bd.bd_em_ensemble_stats(thetas, ps, batch, wb)


large_g_ensemble_stats.kernel_name = KERNEL_NAME
