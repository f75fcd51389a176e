"""K3: the large-K whole-ensemble EM sweep kernel
(``csrc/em_sweep_large_k.cu``) and its wrapper (counterpart of the
reference's ``ops/pallas_em.py``: ``pallas_em_ensemble_stats`` and
``pallas_em_sufficient_stats``, and the ensemble, grouped and
single-restart routes of ``ops/dispatch.py`` that reach it).

:func:`em_ensemble_stats` has K1's contract (``ops/em_bdr.py``): restart-
stacked thetas [S,G,K] and ps [S,K,K,K,R] in, the :class:`SweepStats` of
one sweep out.  On a CPU tensor it runs the plain version,
:func:`em_ensemble_stats_reference` (the row-chunked sweep of
``ops/em.py`` over the S axis); on a CUDA tensor it launches the kernel or
raises.  The kernel takes 21 <= K <= 64, where p[s] no longer fits one
block's shared memory (K1's limit): it runs as an E-step pass over
k-slices of p and a cross-stat pass that owns slices of p_hat (see the
source).  Exact float32 in both engine precision modes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trigenicinteractionpredictor_tpu_torch.ops import _build
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    Batch,
    SweepStats,
    em_sufficient_stats,
)

KERNEL_NAME = "cuda-em-sweep-large-k"
MIN_K, MAX_K = 21, 64
MAX_RATINGS = 3
# Rows per pass-1 block and per pass-2 staging step (kTile, kTile2 in the
# source).
ESTEP_ROWS = 64
CROSS_ROWS = 64
# 227 KB of opt-in shared memory per block on sm_90, less the kernel's
# static buffer and a margin.
_SMEM_LIMIT = 232_448 - 1024
# The plain version's rows per chunk: the reference's EngineConfig default
# (jnp_row_chunk).
DEFAULT_ROW_CHUNK = 16384


class Plan(NamedTuple):
    estep_smem: int     # pass-1 dynamic shared memory, bytes
    cross_threads: int  # pass-2 threads per block
    cross_smem: int     # pass-2 dynamic shared memory, bytes


def sweep_plan(k: int, n_ratings: int) -> Optional[Plan]:
    """The launch plan at this (K, R), or None outside the kernel's range
    (MIN_K..MAX_K, R <= MAX_RATINGS).  Mirrors the shared-memory layouts
    in the source."""
    if not (MIN_K <= k <= MAX_K and 1 <= n_ratings <= MAX_RATINGS):
        return None
    xs, ts = k | 1, -(-k // 4) * 4
    x_floats = -(-(n_ratings * k + 4) * xs // 4) * 4
    estep_smem = 4 * (x_floats + 3 * ESTEP_ROWS * ts + 7 * ESTEP_ROWS)
    lq = (k + 3) // 4
    cross_threads = -(-n_ratings * lq * lq // 32) * 32
    cross_smem = 4 * (2 * CROSS_ROWS * 4 * lq + 5 * CROSS_ROWS)
    if max(estep_smem, cross_smem) > _SMEM_LIMIT or cross_threads > 1024:
        return None
    return Plan(estep_smem, cross_threads, cross_smem)


def em_ensemble_stats_reference(
    thetas, ps, batch: Batch, row_chunk: int = DEFAULT_ROW_CHUNK
) -> SweepStats:
    """The plain version: the ops/em.py sweep over the S axis, summed over
    chunks of ``row_chunk`` rows (0: one chunk)."""
    return em_sufficient_stats(thetas, ps, batch, row_chunk=row_chunk)


def em_ensemble_stats(
    thetas, ps, batch: Batch, row_chunk: int = DEFAULT_ROW_CHUNK
) -> SweepStats:
    """One whole-ensemble sweep: theta_hat [S,G,K], p_hat [S,K,K,K,R] and
    loglik [S] of the pre-update states.  ``row_chunk`` bounds the plain
    version's memory on a CPU tensor; the kernel needs no chunking."""
    if thetas.device.type == "cpu":
        return em_ensemble_stats_reference(thetas, ps, batch, row_chunk)
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
                         f"(K must be {MIN_K}..{MAX_K}, R at most {MAX_RATINGS})")
    if S > 65535:
        raise ValueError(f"{KERNEL_NAME} takes at most 65535 restarts, got {S}")
    theta_hat = torch.zeros_like(thetas)
    p_hat = torch.zeros_like(ps)
    ll = torch.zeros(S, dtype=torch.float32, device=dev)
    if B == 0:
        return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=ll)
    scale = torch.empty((S, B), dtype=torch.float32, device=dev)
    # Split the rows of pass 2 until there are ~4 blocks per SM.
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(-(-B // CROSS_ROWS), -(-4 * n_sm // (K * S))))
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tip_em_sweep_large_k(
            thetas.data_ptr(), ps.data_ptr(), batch.triplets.data_ptr(),
            batch.ratings.data_ptr(), batch.weights.data_ptr(),
            theta_hat.data_ptr(), p_hat.data_ptr(), ll.data_ptr(), scale.data_ptr(),
            S, B, G, K, R, splits, plan.estep_smem, plan.cross_threads,
            plan.cross_smem, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, KERNEL_NAME)
    em_ensemble_stats.launches += 1
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=ll)


em_ensemble_stats.launches = 0
em_ensemble_stats.kernel_name = KERNEL_NAME
