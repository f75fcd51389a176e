"""K1: the whole-ensemble EM sweep kernel (``csrc/em_sweep.cu``) and its
wrapper (counterpart of the reference's ``ops/pallas_em_bdr.py``).

:func:`em_ensemble_stats` takes restart-stacked thetas [S,G,K] and ps
[S,K,K,K,R] and returns the :class:`SweepStats` of one sweep over a batch.
On a CPU tensor it runs the plain version, :func:`em_ensemble_stats_reference`
(the batched sweep of ``ops/em.py``); on a CUDA tensor it launches the
kernel or raises -- it never falls back.  The kernel reads every row's
rating itself, so rows need no rating sort.  It is exact float32 (no
tensor cores, no TF32) in both engine precision modes, and it sums in an
order fixed by the rows and :func:`sweep_grid`, so a call gives the same
bits from run to run: each block writes its partial theta_hat, p_hat and
loglik into its own slot of a buffer, and ``ops/block_sum.py`` adds the
slots up in block order.  Where the blocks' private theta_hats would pass
:data:`THETA_PART_BYTES` (large G x K), the kernel writes the rows'
marginal streams instead and ``ops/em_bd.py::plan_scatter`` sums them
along a gene-sorted plan built on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.ops import _build, block_sum
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    Batch,
    SweepStats,
    em_sufficient_stats,
)

KERNEL_NAME = "cuda-em-sweep"
MAX_K = 20
THREADS = 256
# 227 KB of opt-in shared memory per block on sm_90, less the kernel's
# static reduction buffer and a margin.
SMEM_LIMIT = 232_448 - 1024
TILES = (64, 32, 16, 8)
RESIDENT = 3  # blocks an SM holds at most: __launch_bounds__(256, 3)
# (K, R) whose kernel instance fixes R at compile time and holds four
# blocks an SM: __launch_bounds__(256, 4) (csrc/em_sweep.cu).
FOUR_BLOCK_SHAPES = ((10, 2),)
SM_SMEM = 233_472       # shared memory of one H100 SM, bytes
BLOCK_RESERVED = 1024   # of it, reserved per resident block
# K whose E-step runs in an instance of its own, with no pads; every other
# K runs in the instance of K rounded up to 4 (csrc/em_sweep.cu kc_of).
EXACT_K = (10,)
# Largest buffer of private theta_hats (S x blocks x G x K floats) K1
# takes; past it K1 writes marginal streams for plan_scatter instead.  At
# the headline shape (S = 10, G = 1000, K = 10) the private form takes
# 16 MB; at 256 MiB, zeroing it and summing it cost ~0.16 ms a sweep.
THETA_PART_BYTES = 256 << 20


def tile_smem_bytes(k: int, n_ratings: int, tile: int) -> int:
    """Shared memory of K9's tile buffers (``csrc/em_tile.cuh`` carve; K1,
    K5a and K4 share their own, :func:`sweep_smem_bytes`): p[s]
    and its cross-stats with l and m padded to K4 = K rounded up to 4, then
    per-slot vectors over NS = tile rounded up to 4 plus 4 (R - 1) slots
    (each rating's rows start a quad; T/U at least 27 tile + 256 words,
    which hold the keys of the tile's 3 tile entries and the keyed sum's
    per-warp lists after the E-step), then per-row vectors of the tile."""
    k4 = -(-k // 4) * 4
    ns = -(-tile // 4) * 4 + 4 * (n_ratings - 1)
    tv = max(k * k * ns, 27 * tile + 256)  # T/U, then the keys and the keyed sum's lists
    floats = 2 * n_ratings * k * k4 * k4 + tv + 3 * k4 * ns + 3 * k * ns + 2 * ns + tile
    ints = 5 * tile + 8
    return 4 * (floats + ints)


def sweep_kc(k: int) -> int:
    """The E-step instance that runs K: K itself if in EXACT_K, else K
    rounded up to 4."""
    return k if k in EXACT_K else -(-k // 4) * 4


def sweep_smem_bytes(k: int, n_ratings: int, tile: int) -> int:
    """Shared memory of K1's tile buffers (``csrc/em_row_estep.cuh`` carve,
    which K5a and K4 share):
    p[s] staged for the E-step as [R][K][KC][LS] (KC = :func:`sweep_kc`;
    LS = KC rounded up to a whole, odd number of float4s; a rating's slice
    rounded up to 16 words mod 32), its cross-stats [R][K][K4][K4], the
    keys and the keyed sum's lists (27 tile + 256 words), then theta, A and
    the per-slot and per-row vectors as :func:`tile_smem_bytes`."""
    kc = sweep_kc(k)
    k4 = -(-k // 4) * 4
    ns = -(-tile // 4) * 4 + 4 * (n_ratings - 1)
    quads = -(-kc // 4)
    ls = 4 * quads if quads % 2 else 4 * quads + 4
    rating = k * kc * ls + (48 - k * kc * ls % 32) % 32
    floats = (n_ratings * rating + n_ratings * k * k4 * k4 + 27 * tile + 256
              + 3 * k4 * ns + 3 * k * ns + 2 * ns + tile)
    return 4 * (floats + 5 * tile + 8)


def sweep_plan(k: int, n_ratings: int) -> Optional[Tuple[int, int]]:
    """(rows per tile, dynamic shared-memory bytes) for the kernel at this
    (K, R), or None when K is outside the kernel's range (1..MAX_K) or
    p[s] and its cross-stats do not fit one block's shared memory."""
    if not 1 <= k <= MAX_K:
        return None
    for tile in TILES:
        smem = sweep_smem_bytes(k, n_ratings, tile)
        if smem <= SMEM_LIMIT:
            return tile, smem
    return None


def sweep_resident(k: int, n_ratings: int, smem: int) -> int:
    """Blocks of K1's instance for (K, R) one SM holds at ``smem`` bytes
    each: its launch bound (4 for FOUR_BLOCK_SHAPES, else RESIDENT) or what
    the SM's shared memory holds, the fewer."""
    bound = 4 if (k, n_ratings) in FOUR_BLOCK_SHAPES else RESIDENT
    return min(bound, SM_SMEM // (smem + BLOCK_RESERVED))


def launch_plan(n_rows: int, n_samples: int, tile: int, n_sm: int,
                max_blocks: int = 0, resident: int = RESIDENT) -> Tuple[int, int]:
    """(rows per block, blocks) of the grid (blocks, S) of the kernels on
    ``csrc/em_tile.cuh`` that walk rows in runs (K1 and K5a through
    :func:`sweep_grid`, K9): the fewest waves (1..3) of ``resident`` blocks
    an SM whose blocks fill at least 95% of them (at most ``max_blocks`` if
    > 0), each block a run of whole tiles.  A pure function of the rows,
    S, the tile and the card's SM count, so on one card it fixes the order
    of every sum the sweep makes."""
    n_tiles = -(-n_rows // tile)
    slots = resident * n_sm
    for waves in (1, 2, 3):
        blocks = max(1, min(n_tiles, waves * slots // n_samples))
        if blocks * n_samples >= 0.95 * waves * slots:
            break
    if max_blocks > 0:
        blocks = min(blocks, max_blocks)
    rows_per_block = -(-n_tiles // blocks) * tile
    return rows_per_block, -(-n_rows // rows_per_block)


def sweep_grid(n_rows: int, n_samples: int, k: int, n_ratings: int,
               n_sm: int) -> Tuple[int, int]:
    """K1's (rows per block, blocks) at (K, R): waves of the blocks an SM
    holds of its instance at its plan (:func:`sweep_resident`)."""
    tile, smem = sweep_plan(k, n_ratings)
    return launch_plan(n_rows, n_samples, tile, n_sm,
                       resident=sweep_resident(k, n_ratings, smem))


def sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# csrc/em_tile.cuh keyed_sum: a bucket (one warp) a key by bucket_of's
# multiplicative hash, rounds of a warp's 32 entries.
BUCKET_BITS = 3
BUCKET_HASH = 2654435761


class KeyCensus(NamedTuple):
    """What K1's key sum (``tip::keyed_sum`` in ``add_marginals``) does a
    restart: ``tiles`` it runs, the distinct keys (genes) a tile holds,
    and the longest serial chain a tile, the most marginals one lane sums
    one after another over the tile's rounds, taking the largest over the
    warps; ``keys`` and ``chain`` are means over the tiles."""

    tiles: int
    keys: float
    chain: float
    chain_max: int


def _warp_chain(keys: np.ndarray, k: int) -> int:
    """The most marginals one lane of a warp sums for the warp's entries
    ``keys`` (in entry order), as ``keyed_sum`` walks them: per round of 32
    entries, groups of one key (led by the key's first lane, in lane
    order) spread as items (group, k) over the lanes, item i on lane i %
    32, and each item sums its group's entries one after another."""
    load = np.zeros(32, np.int64)
    for r in range(0, keys.size, 32):
        _, first, counts = np.unique(keys[r:r + 32], return_index=True, return_counts=True)
        sizes = np.repeat(counts[np.argsort(first)], k)
        load += np.bincount(np.arange(sizes.size) % 32, weights=sizes,
                            minlength=32).astype(np.int64)
    return int(load.max())


def key_census(triplets, weights, n_samples: int, k: int, n_ratings: int,
               n_sm: int) -> KeyCensus:
    """K1's key sum over these rows, walked as ``sweep_grid`` and the
    kernel cut them (blocks of whole tiles, a block's last tile short):
    per tile the entries e = 3 row + position of the rows of nonzero
    weight, keyed by gene, each key in the warp ``bucket_of`` gives it.
    Every restart runs the same tiles.  A pure host function: the fit
    does not call it."""
    tile = sweep_plan(k, n_ratings)[0]
    trip = np.asarray(triplets, np.int64)
    keys = np.where(np.asarray(weights)[:, None] != 0, trip, -1)
    buckets = ((keys * BUCKET_HASH) & 0xFFFFFFFF) >> (32 - BUCKET_BITS)
    n = trip.shape[0]
    rows_per_block, blocks = sweep_grid(n, n_samples, k, n_ratings, n_sm)
    distinct, chains = [], []
    for b in range(blocks):
        end = min(n, (b + 1) * rows_per_block)
        for row0 in range(b * rows_per_block, end, tile):
            kt = keys[row0:min(row0 + tile, end)].reshape(-1)
            bt = buckets[row0:min(row0 + tile, end)].reshape(-1)
            live = kt >= 0
            distinct.append(np.unique(kt[live]).size)
            chains.append(max(_warp_chain(kt[live & (bt == w)], k)
                              for w in range(1 << BUCKET_BITS)))
    return KeyCensus(len(chains), float(np.mean(distinct)), float(np.mean(chains)),
                     int(max(chains)))


def sweep_launch(thetas, ps, batch: Batch, name: str, streams=None, plan=None):
    """Launch ``csrc/em_sweep.cu`` on checked inputs: the marginals into
    ``streams`` [3, B, S*K] (K5a; also K1 past THETA_PART_BYTES) or, with
    none, into the blocks' private theta_hats.  Returns (part [S, blocks,
    LD], zeroed then filled, LD = (G K if no streams) + K^3 R + 1)."""
    S, G, K = thetas.shape
    R = ps.shape[-1]
    B = batch.triplets.shape[0]
    dev = thetas.device
    tile, smem = plan
    rows_per_block, blocks = sweep_grid(B, S, K, R, sm_count(dev))
    ld = (0 if streams is not None else G * K) + K ** 3 * R + 1
    part = torch.zeros((S, blocks, ld), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tip_em_sweep(
            thetas.data_ptr(), ps.data_ptr(), batch.triplets.data_ptr(),
            batch.ratings.data_ptr(), batch.weights.data_ptr(),
            None if streams is None else streams.data_ptr(), part.data_ptr(),
            S, B, G, K, R, tile, rows_per_block, THREADS, smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, name)
    return part


def check_inputs(thetas, ps, batch: Batch, name: str):
    """Raise unless the kernel takes these tensors; returns its (tile, smem)."""
    S, G, K = thetas.shape
    R = ps.shape[-1]
    B = batch.triplets.shape[0]
    dev = thetas.device
    _build.require("thetas", thetas, torch.float32, (S, G, K), dev)
    _build.require("ps", ps, torch.float32, (S, K, K, K, R), dev)
    _build.require("triplets", batch.triplets, torch.int32, (B, 3), dev)
    _build.require("ratings", batch.ratings, torch.int32, (B,), dev)
    _build.require("weights", batch.weights, torch.float32, (B,), dev)
    plan = sweep_plan(K, R)
    if plan is None:
        raise ValueError(f"{name} does not take K={K}, R={R} "
                         f"(K must be 1..{MAX_K} and p[s] must fit shared memory)")
    if S > 65535:
        raise ValueError(f"{name} takes at most 65535 restarts, got {S}")
    return plan


def theta_in_part(n_rows: int, n_samples: int, n_genes: int, k: int, n_ratings: int,
                  n_sm: int) -> bool:
    """True where K1 keeps theta_hat in block-private partials (the blocks'
    [G, K] slots fit THETA_PART_BYTES); else it writes marginal streams."""
    _, blocks = sweep_grid(n_rows, n_samples, k, n_ratings, n_sm)
    return 4 * n_samples * blocks * n_genes * k <= THETA_PART_BYTES


def em_ensemble_stats_reference(thetas, ps, batch: Batch) -> SweepStats:
    """The plain version: the ops/em.py sweep, batched over the S axis."""
    return em_sufficient_stats(thetas, ps, batch)


def em_ensemble_stats(thetas, ps, batch: Batch) -> SweepStats:
    """One whole-ensemble sweep: theta_hat [S,G,K], p_hat [S,K,K,K,R] and
    loglik [S] of the pre-update states."""
    if thetas.device.type == "cpu":
        return em_ensemble_stats_reference(thetas, ps, batch)
    plan = check_inputs(thetas, ps, batch, KERNEL_NAME)
    S, G, K = thetas.shape
    R = ps.shape[-1]
    B = batch.triplets.shape[0]
    dev = thetas.device
    if B == 0:
        return SweepStats(theta_hat=torch.zeros_like(thetas), p_hat=torch.zeros_like(ps),
                          loglik=torch.zeros(S, dtype=torch.float32, device=dev))
    cells = K ** 3 * R
    if theta_in_part(B, S, G, K, R, sm_count(dev)):
        part = sweep_launch(thetas, ps, batch, KERNEL_NAME, plan=plan)
        em_ensemble_stats.launches += 1
        th, ph, ll = block_sum.block_sum([
            block_sum.Segment(part, 0, G * K),
            block_sum.Segment(part, G * K, cells),
            block_sum.Segment(part, G * K + cells, 1)])
        theta_hat = th.view(S, G, K)
    else:
        from trigenicinteractionpredictor_tpu_torch.ops import em_bd, em_large_g

        streams = torch.empty((3, B, S * K), dtype=torch.float32, device=dev)
        part = sweep_launch(thetas, ps, batch, KERNEL_NAME, streams=streams, plan=plan)
        em_ensemble_stats.launches += 1
        ph, ll = block_sum.block_sum([block_sum.Segment(part, 0, cells),
                                      block_sum.Segment(part, cells, 1)])
        perm, lid, off = em_large_g.device_scatter_plan(batch.triplets.t().reshape(-1), G)
        theta_hat = em_bd.plan_scatter(streams, perm, lid, off, em_large_g.DEFAULT_WB, G, K)
    return SweepStats(theta_hat=theta_hat, p_hat=ph.view(ps.shape), loglik=ll.view(S))


em_ensemble_stats.launches = 0
em_ensemble_stats.kernel_name = KERNEL_NAME
