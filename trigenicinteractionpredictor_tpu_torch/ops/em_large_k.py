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
raises.  The kernel takes 21 <= K <= 72, where p[s] no longer fits one
block's shared memory (K1's limit): it runs as an E-step pass over
k-slices of p and a cross-stat pass that owns slices of p_hat (see the
source), both over the rows in rating order (:func:`rating_order`, an
index array the kernel reads rows through).  Exact float32 in both engine
precision modes.
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
MIN_K, MAX_K = 21, 72
MAX_RATINGS = 3
# Pass 1: rows per block and the row stride of its theta tiles (kRows1,
# kTS in the source); pass 2: rows per stage (kRows2) and the block's
# thread cap (kMaxThreads2).
ESTEP_ROWS = 64
ESTEP_TS = ESTEP_ROWS + 4
CROSS_ROWS = 64
CROSS_MAX_THREADS = 384
# 227 KB of opt-in shared memory per block on sm_90, less a margin.
_SMEM_LIMIT = 232_448 - 1024
# The plain version's rows per chunk: the reference's EngineConfig default
# (jnp_row_chunk).
DEFAULT_ROW_CHUNK = 16384


class Plan(NamedTuple):
    kc: int             # K rounded up to 4: the packed p's row length
    estep_threads: int  # pass-1 threads per block (16 x KC/4)
    estep_smem: int     # pass-1 dynamic shared memory, bytes
    nk: int             # pass-2 k's per block
    vec: int            # pass-2 floats per gather copy (4, 2 or 1)
    cross_threads: int  # pass-2 threads per block
    cross_smem: int     # pass-2 dynamic shared memory, bytes


def sweep_plan(k: int, n_ratings: int) -> Optional[Plan]:
    """The launch plan at this (K, R), or None outside the kernel's range
    (MIN_K..MAX_K, R <= MAX_RATINGS).  Mirrors the shared-memory layouts
    in the source.  Pass 2 copies rows in vec floats, the widest that K
    allows, and takes, among blocks of at least 4 warps, the k's per block
    that cost least over all k chunks: each chunk costs its warps plus its
    rows' gathers, which on the H100 at K = 50 in 4-byte copies cost about
    as much as a 6-warp block's compute (so 6 K / 50 / vec warps)."""
    if not (MIN_K <= k <= MAX_K and 1 <= n_ratings <= MAX_RATINGS):
        return None
    kc = -(-k // 4) * 4
    ncg = kc // 4
    estep_smem = 4 * (2 * k * kc + 3 * kc * ESTEP_TS + 2 * ncg * ESTEP_ROWS
                      + 2 * ESTEP_ROWS + 4 * ESTEP_ROWS)
    lq, mq = -(-k // 4), -(-k // 8)
    per_k = lq * mq
    vec = 4 if k % 4 == 0 else (2 if k % 2 == 0 else 1)
    gather = 6 * k / 50 / vec
    fits = range(1, CROSS_MAX_THREADS // per_k + 1)
    nk = min([nk for nk in fits if nk * per_k >= 128] or fits,
             key=lambda nk: (-(-k // nk) * (-(-nk * per_k // 32) + gather), -nk))
    cross_threads = nk * per_k
    cross_smem = 4 * (2 * CROSS_ROWS * (2 * 4 * lq + 8 * mq) + 3 * CROSS_ROWS * 4
                      + 3 * CROSS_ROWS)
    if max(estep_smem, cross_smem) > _SMEM_LIMIT:
        return None
    return Plan(kc, 16 * ncg, estep_smem, nk, vec, cross_threads, cross_smem)


def rating_order(ratings: torch.Tensor, n_ratings: int):
    """(order, off): a stable permutation of the rows by rating (int32 [B],
    sorted position -> row) and the rating segments of it (int32 [R + 1]:
    rating r at sorted positions off[r] .. off[r + 1]).  Rows with a rating
    outside 0..R-1 sort last, past off[R].  Planning, on the rows' device:
    it moves no row data."""
    key = torch.where((ratings >= 0) & (ratings < n_ratings), ratings,
                      torch.full_like(ratings, n_ratings)).long()
    order = torch.argsort(key, stable=True).to(torch.int32)
    off = torch.zeros(n_ratings + 1, dtype=torch.int32, device=ratings.device)
    off[1:] = torch.cumsum(torch.bincount(key, minlength=n_ratings + 1)[:n_ratings], 0)
    return order, off


def cross_splits(k: int, s: int, n_rows: int, n_ratings: int, plan: Plan, dev) -> int:
    """Pass 2's row splits per rating: ~8 blocks per SM over the grid, and
    at least one partial sum of rows a split."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = -(-k // plan.nk) * s * n_ratings
    return max(1, min(-(-n_rows // (n_ratings * 64)), -(-8 * n_sm // blocks)))


def launch_buffers(s: int, b: int, k: int, n_ratings: int, plan: Plan, dev):
    """The kernel's scratch: packed p [S, R, K, 2, K, KC], scale [S, B]
    and rowinfo [B, 4] (both in rating order)."""
    pk = torch.empty((s, n_ratings, k, 2, k, plan.kc), dtype=torch.float32, device=dev)
    scale = torch.empty((s, b), dtype=torch.float32, device=dev)
    rowinfo = torch.empty((b, 4), dtype=torch.int32, device=dev)
    return pk, scale, rowinfo


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
    order, off = rating_order(batch.ratings, R)
    pk, scale, rowinfo = launch_buffers(S, B, K, R, plan, dev)
    splits = cross_splits(K, S, B, R, plan, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tip_em_sweep_large_k(
            thetas.data_ptr(), ps.data_ptr(), batch.triplets.data_ptr(),
            batch.weights.data_ptr(), order.data_ptr(), off.data_ptr(), pk.data_ptr(),
            theta_hat.data_ptr(), p_hat.data_ptr(), ll.data_ptr(), scale.data_ptr(),
            rowinfo.data_ptr(), S, B, G, K, R, plan.kc, plan.estep_threads,
            plan.estep_smem, plan.nk, splits, plan.vec, plan.cross_threads, plan.cross_smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, KERNEL_NAME)
    em_ensemble_stats.launches += 1
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=ll)


em_ensemble_stats.launches = 0
em_ensemble_stats.kernel_name = KERNEL_NAME
