"""K6: the large-G sweep at any ensemble width, and the scatter plan of
every large-G route (counterpart of the reference's
``ops/pallas_em_large.py``: ``ScatterPlan``, ``make_scatter_plan``,
``_pallas_stats_large`` and ``large_g_ensemble_stats``).

No buffer of the sweep scales with G: an E-step writes per-row position
marginals (streams), and ``plan_scatter`` segment-sums them into
theta_hat along a host plan.  The reference runs a per-restart E-step
kernel here and a block-diagonal one on the bd-plan route; on the card one
E-step kernel (``csrc/em_streams.cu``) and one scatter kernel
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


def large_g_ensemble_stats(thetas, ps, batch: Batch, wb: int = DEFAULT_WB) -> SweepStats:
    """One whole-ensemble sweep at any G: ``ops/em_bd.py``'s E-step streams
    and plan scatter.  ``batch`` carries a 3-position scatter plan of
    ``wb``-gene blocks for exactly its rows."""
    return em_bd.bd_em_ensemble_stats(thetas, ps, batch, wb)


large_g_ensemble_stats.kernel_name = KERNEL_NAME
