"""K9: the rating-sorted whole-ensemble EM sweep kernel
(``csrc/em_rsorted.cu``) and its wrapper (counterpart of the reference's
``ops/pallas_em_rsorted.py``: ``_pallas_stats_rsorted`` and
``rsorted_em_ensemble_stats``).

Rows come in the order of a rating-sort plan (:func:`rating_sort_pad`,
:func:`apply_rating_sort`, NumPy, from ``ops/rsort_plan.py``): every tile
of ``tile_b`` rows holds one rating, and ``batch.tile_rating`` (int32
[n_tiles]) names it.  The sweep takes each row's rating from that table,
never from ``batch.ratings``.  Its contract is K1's otherwise
(``ops/em_bdr.py``): restart-stacked thetas [S,G,K] and ps [S,K,K,K,R] in,
the :class:`SweepStats` of one sweep out.

On a CPU tensor :func:`rsorted_em_ensemble_stats` runs the plain version,
:func:`rsorted_em_ensemble_stats_reference`; on a CUDA tensor it launches
the kernel or raises.  A block stages one rating's slice of p[s], not all
R, so the kernel reaches K = 28 (:data:`MAX_K`; K1 stops at 20).  As K1,
it sums in an order fixed by the rows and the plan: per-block partials,
added up in block order by ``ops/block_sum.py``.

No dispatch route returns this sweep, as the reference's dispatch never
returns its kernel: a caller asks for it with ``fit(...,
stats_fn=stats_fn(tile_b))``, whose record sorts a classic fit's split
into the plan's layout (:func:`fit_batch`) and carries ``tile_b``, so the
trainer sorts every stepwise minibatch too.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.ops import _build, block_sum, em_bdr
from trigenicinteractionpredictor_tpu_torch.ops.dispatch import Sweep
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    Batch,
    SweepStats,
    em_sufficient_stats,
    make_batch,
)
from trigenicinteractionpredictor_tpu_torch.ops.rsort_plan import (  # noqa: F401
    DEFAULT_TILE_B,
    RatingSortPlan,
    apply_rating_sort,
    rating_sort_pad,
)
from trigenicinteractionpredictor_tpu_torch.utils.tracing import span

KERNEL_NAME = "cuda-em-rsorted"
# The largest K whose one-rating slice of p[s], its cross-stats and an
# 8-row tile fit one block's shared memory (em_bdr.tile_smem_bytes at
# R = 1: 210,104 bytes at K = 28, 231,868 at K = 29).
MAX_K = 28


def sweep_plan(k: int, tile_b: int = DEFAULT_TILE_B) -> Optional[Tuple[int, int]]:
    """(kernel rows per tile, dynamic shared-memory bytes) at this K for
    plan tiles of ``tile_b`` rows: the largest kernel tile that divides
    ``tile_b`` (so no kernel tile straddles two ratings) and whose buffers
    fit; None when K is outside 1..MAX_K or no tile does."""
    if not 1 <= k <= MAX_K:
        return None
    for tile in em_bdr.TILES:
        smem = em_bdr.tile_smem_bytes(k, 1, tile)
        if tile_b % tile == 0 and smem <= em_bdr.SMEM_LIMIT:
            return tile, smem
    return None


def rsorted_launch_plan(n_rows: int, n_samples: int, n_genes: int, k: int, tile: int,
                        n_sm: int) -> Tuple[int, int]:
    """(rows per block, blocks) of the kernel: K1's plan, with the blocks
    cut so that their private theta_hats [S, blocks, G, K] stay within
    ``em_bdr.THETA_PART_BYTES`` (K9 has no streams form)."""
    cap = max(1, em_bdr.THETA_PART_BYTES // (4 * n_samples * n_genes * k))
    return em_bdr.launch_plan(n_rows, n_samples, tile, n_sm, max_blocks=cap)


def _tile_table(batch: Batch, tile_b: int) -> torch.Tensor:
    """``batch.tile_rating``, checked against the rows: raise unless it
    covers them in whole tiles of ``tile_b``."""
    if batch.tile_rating is None:
        raise ValueError(
            "rsorted stats need batch.tile_rating; build with "
            "rating_sort_pad(...) and reorder rows with apply_rating_sort"
        )
    B = batch.triplets.shape[0]
    n_tiles = batch.tile_rating.shape[0]
    if tile_b <= 0 or n_tiles * tile_b != B:
        raise ValueError(f"{KERNEL_NAME}: {n_tiles} tiles of {tile_b} rows for a batch "
                         f"of {B} rows")
    return batch.tile_rating


def rsorted_em_ensemble_stats_reference(thetas, ps, batch: Batch,
                                        tile_b: int = DEFAULT_TILE_B,
                                        row_chunk: int = 0) -> SweepStats:
    """The plain version: the ops/em.py sweep with each row's rating taken
    from the tile table (``row_chunk`` > 0 sums it over chunks of that many
    rows)."""
    ratings = _tile_table(batch, tile_b).repeat_interleave(tile_b)
    rows = Batch(batch.triplets, ratings.to(batch.triplets.dtype), batch.weights)
    return em_sufficient_stats(thetas, ps, rows, row_chunk=row_chunk)


def rsorted_em_ensemble_stats(thetas, ps, batch: Batch,
                              tile_b: int = DEFAULT_TILE_B) -> SweepStats:
    """One whole-ensemble sweep over rating-sorted rows: theta_hat [S,G,K],
    p_hat [S,K,K,K,R] and loglik [S] of the pre-update states."""
    tile_r = _tile_table(batch, tile_b)
    if thetas.device.type == "cpu":
        return rsorted_em_ensemble_stats_reference(thetas, ps, batch, tile_b)
    S, G, K = thetas.shape
    R = ps.shape[-1]
    B = batch.triplets.shape[0]
    dev = thetas.device
    _build.require("thetas", thetas, torch.float32, (S, G, K), dev)
    _build.require("ps", ps, torch.float32, (S, K, K, K, R), dev)
    _build.require("triplets", batch.triplets, torch.int32, (B, 3), dev)
    _build.require("weights", batch.weights, torch.float32, (B,), dev)
    _build.require("tile_rating", tile_r, torch.int32, (B // tile_b,), dev)
    plan = sweep_plan(K, tile_b)
    if plan is None:
        raise ValueError(f"{KERNEL_NAME} does not take K={K} with plan tiles of {tile_b} "
                         f"rows (K must be 1..{MAX_K} and a kernel tile of "
                         f"{em_bdr.TILES} must divide the plan tile and fit)")
    if S > 65535:
        raise ValueError(f"{KERNEL_NAME} takes at most 65535 restarts, got {S}")
    tile, smem = plan
    if B == 0:
        return SweepStats(theta_hat=torch.zeros_like(thetas), p_hat=torch.zeros_like(ps),
                          loglik=torch.zeros(S, dtype=torch.float32, device=dev))
    rows_per_block, blocks = rsorted_launch_plan(B, S, G, K, tile, em_bdr.sm_count(dev))
    cells = K ** 3 * R
    part = torch.zeros((S, blocks, G * K + cells + 1), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tip_em_rsorted(
            thetas.data_ptr(), ps.data_ptr(), batch.triplets.data_ptr(),
            tile_r.data_ptr(), batch.weights.data_ptr(), part.data_ptr(),
            S, B, G, K, R, tile, tile_b, rows_per_block, em_bdr.THREADS, smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, KERNEL_NAME)
    rsorted_em_ensemble_stats.launches += 1
    th, ph, ll = block_sum.block_sum([
        block_sum.Segment(part, 0, G * K),
        block_sum.Segment(part, G * K, cells),
        block_sum.Segment(part, G * K + cells, 1)])
    return SweepStats(theta_hat=th.view(S, G, K), p_hat=ph.view(ps.shape), loglik=ll.view(S))


rsorted_em_ensemble_stats.launches = 0
rsorted_em_ensemble_stats.kernel_name = KERNEL_NAME


def fit_batch(ds, dev, tile_b: int = DEFAULT_TILE_B):
    """K9's fit batch: ``ds``'s rows sorted into plan tiles on the host,
    with the tile table, on ``dev``."""
    with span("fit.plan"):
        plan = rating_sort_pad(np.asarray(ds.ratings), ds.n_ratings, tile=tile_b)
        rows = apply_rating_sort(plan, np.asarray(ds.triplets), np.asarray(ds.ratings),
                                 np.asarray(ds.weights))
    return (make_batch(*rows, dev, tile_rating=plan.tile_r),
            {"tile_b": tile_b, "padded_rows": int(plan.n_rows)})


def stats_fn(tile_b: int = DEFAULT_TILE_B) -> Sweep:
    """The sweep as a ``fit`` stats function on plan tiles of ``tile_b``
    rows (ValueError unless ``tile_b`` > 0)."""
    if tile_b <= 0:
        raise ValueError(f"{KERNEL_NAME} needs plan tiles of at least one row, "
                         f"got tile_b={tile_b}")
    return Sweep(KERNEL_NAME, functools.partial(rsorted_em_ensemble_stats, tile_b=tile_b),
                 kernels=(rsorted_em_ensemble_stats, block_sum.block_sum), tile_b=tile_b,
                 batch=functools.partial(fit_batch, tile_b=tile_b))
