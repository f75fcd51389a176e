"""K1: the whole-ensemble EM sweep kernel (``csrc/em_sweep.cu``) and its
wrapper (counterpart of the reference's ``ops/pallas_em_bdr.py``).

:func:`em_ensemble_stats` takes restart-stacked thetas [S,G,K] and ps
[S,K,K,K,R] and returns the :class:`SweepStats` of one sweep over a batch.
On a CPU tensor it runs the plain version, :func:`em_ensemble_stats_reference`
(the batched sweep of ``ops/em.py``); on a CUDA tensor it launches the
kernel or raises -- it never falls back.  The kernel reads every row's
rating itself, so rows need no rating sort.  It is exact float32 (no
tensor cores, no TF32) in both engine precision modes, and it sums in an
order fixed by the rows and :func:`launch_plan`, so a call gives the same
bits from run to run: each block writes its partial theta_hat, p_hat and
loglik into its own slot of a buffer, and ``ops/block_sum.py`` adds the
slots up in block order.  Where the blocks' private theta_hats would pass
:data:`THETA_PART_BYTES` (large G x K), the kernel writes the rows'
marginal streams instead and ``ops/em_bd.py::plan_scatter`` sums them
along a gene-sorted plan built on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
RESIDENT = 3  # blocks an SM holds: __launch_bounds__(256, 3)
# Largest buffer of private theta_hats (S x blocks x G x K floats) K1
# takes; past it K1 writes marginal streams for plan_scatter instead.  At
# the headline shape (S = 10, G = 1000, K = 10) the private form takes
# 16 MB; at 256 MiB, zeroing it and summing it cost ~0.16 ms a sweep.
THETA_PART_BYTES = 256 << 20


def tile_smem_bytes(k: int, n_ratings: int, tile: int) -> int:
    """Shared memory of the tile buffers (``csrc/em_tile.cuh`` carve): p[s]
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


def sweep_plan(k: int, n_ratings: int) -> Optional[Tuple[int, int]]:
    """(rows per tile, dynamic shared-memory bytes) for the kernel at this
    (K, R), or None when K is outside the kernel's range (1..MAX_K) or
    p[s] and its cross-stats do not fit one block's shared memory."""
    if not 1 <= k <= MAX_K:
        return None
    for tile in TILES:
        smem = tile_smem_bytes(k, n_ratings, tile)
        if smem <= SMEM_LIMIT:
            return tile, smem
    return None


def launch_plan(n_rows: int, n_samples: int, tile: int, n_sm: int,
                max_blocks: int = 0) -> Tuple[int, int]:
    """(rows per block, blocks) of the grid (blocks, S) of the kernels on
    ``csrc/em_tile.cuh`` that walk rows in runs (K1, K5a, K9): the fewest
    waves (1..3) of RESIDENT blocks an SM whose blocks fill at least 95%
    of them (at most ``max_blocks`` if > 0), each block a run of whole
    tiles.  A pure function of the rows, S, the tile and the card's SM
    count, so on one card it fixes the order of every sum the sweep
    makes."""
    n_tiles = -(-n_rows // tile)
    slots = RESIDENT * n_sm
    for waves in (1, 2, 3):
        blocks = max(1, min(n_tiles, waves * slots // n_samples))
        if blocks * n_samples >= 0.95 * waves * slots:
            break
    if max_blocks > 0:
        blocks = min(blocks, max_blocks)
    rows_per_block = -(-n_tiles // blocks) * tile
    return rows_per_block, -(-n_rows // rows_per_block)


def sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
    rows_per_block, blocks = launch_plan(B, S, tile, sm_count(dev))
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


def theta_in_part(n_rows: int, n_samples: int, n_genes: int, k: int, tile: int,
                  n_sm: int) -> bool:
    """True where K1 keeps theta_hat in block-private partials (the blocks'
    [G, K] slots fit THETA_PART_BYTES); else it writes marginal streams."""
    _, blocks = launch_plan(n_rows, n_samples, tile, n_sm)
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
    if theta_in_part(B, S, G, K, plan[0], sm_count(dev)):
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
