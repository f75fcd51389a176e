"""K1: the whole-ensemble EM sweep kernel (``csrc/em_sweep.cu``) and its
wrapper (counterpart of the reference's ``ops/pallas_em_bdr.py``).

:func:`em_ensemble_stats` takes restart-stacked thetas [S,G,K] and ps
[S,K,K,K,R] and returns the :class:`SweepStats` of one sweep over a batch.
On a CPU tensor it runs the plain version, :func:`em_ensemble_stats_reference`
(the batched sweep of ``ops/em.py``); on a CUDA tensor it launches the
kernel or raises -- it never falls back.  The kernel reads every row's
rating itself, so rows need no rating sort.  It is exact float32 (no
tensor cores, no TF32) in both engine precision modes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from trigenicinteractionpredictor_tpu_torch.ops import _build
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


def tile_smem_bytes(k: int, n_ratings: int, tile: int) -> int:
    """Shared memory of the tile buffers (``csrc/em_tile.cuh`` carve): p[s]
    and its cross-stats with l and m padded to K4 = K rounded up to 4, then
    per-slot vectors over NS = tile rounded up to 4 plus 4 (R - 1) slots
    (each rating's rows start a quad), then per-row vectors of the tile."""
    k4 = -(-k // 4) * 4
    ns = -(-tile // 4) * 4 + 4 * (n_ratings - 1)
    floats = 2 * n_ratings * k * k4 * k4 + k * k * ns + 3 * k4 * ns + 3 * k * ns + 2 * ns + tile
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


def em_ensemble_stats_reference(thetas, ps, batch: Batch) -> SweepStats:
    """The plain version: the ops/em.py sweep, batched over the S axis."""
    return em_sufficient_stats(thetas, ps, batch)


def em_ensemble_stats(thetas, ps, batch: Batch) -> SweepStats:
    """One whole-ensemble sweep: theta_hat [S,G,K], p_hat [S,K,K,K,R] and
    loglik [S] of the pre-update states."""
    if thetas.device.type == "cpu":
        return em_ensemble_stats_reference(thetas, ps, batch)
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
        raise ValueError(f"{KERNEL_NAME} does not take K={K}, R={R} "
                         f"(K must be 1..{MAX_K} and p[s] must fit shared memory)")
    if S > 65535:
        raise ValueError(f"{KERNEL_NAME} takes at most 65535 restarts, got {S}")
    tile, smem = plan
    theta_hat = torch.zeros_like(thetas)
    p_hat = torch.zeros_like(ps)
    ll = torch.zeros(S, dtype=torch.float32, device=thetas.device)
    if B == 0:
        return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=ll)
    # Enough row blocks for ~8 blocks per SM across the S restarts.
    n_sm = torch.cuda.get_device_properties(thetas.device).multi_processor_count
    n_tiles = -(-B // tile)
    blocks_x = max(1, min(n_tiles, -(-8 * n_sm // S)))
    rows_per_block = -(-n_tiles // blocks_x) * tile
    lib = _build.library()
    with torch.cuda.device(thetas.device):
        err = lib.tip_em_sweep(
            thetas.data_ptr(), ps.data_ptr(), batch.triplets.data_ptr(),
            batch.ratings.data_ptr(), batch.weights.data_ptr(),
            theta_hat.data_ptr(), p_hat.data_ptr(), ll.data_ptr(),
            S, B, G, K, R, tile, rows_per_block, THREADS, smem,
            torch.cuda.current_stream(thetas.device).cuda_stream,
        )
    _build.check(err, KERNEL_NAME)
    em_ensemble_stats.launches += 1
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=ll)


em_ensemble_stats.launches = 0
em_ensemble_stats.kernel_name = KERNEL_NAME
