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
precision modes.  No atomics: the kernel writes the rows' marginals as
streams and its p_hat and loglik as per-block partials, and
:func:`finish_sweep` sums them in a fixed order (``ops/em_bd.py``'s plan
scatter along a gene-sorted plan, ``ops/block_sum.py``), so a call gives
the same bits from run to run.

The rating order and the gene-sorted plan of the streams' slots form the
call's :class:`StreamPlan` (:func:`stream_plan`): stable sorts on the rows'
device, their offsets by ``torch.searchsorted`` on the sorted keys, so no
value comes back to the host and the call never waits on the card.  A
classic fit's rows never change, so its batch carries the plan, built
once (:func:`fit_batch`; ``Batch.rating_order`` .. ``stream_offsets``); a
batch without one (a stepwise minibatch) gets its plan on every call.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trigenicinteractionpredictor_tpu_torch.ops import _build, block_sum, em_bd, em_large_g
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    Batch,
    SweepStats,
    em_sufficient_stats,
    make_batch,
)
from trigenicinteractionpredictor_tpu_torch.utils.tracing import span

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
    it moves no row data, and it reads nothing back to the host (the
    offsets are searches of the sorted keys, where a bincount would size
    its output from the keys' maximum)."""
    key = torch.where((ratings >= 0) & (ratings < n_ratings), ratings,
                      torch.full_like(ratings, n_ratings)).to(torch.int32)
    key, order = torch.sort(key, stable=True)
    bounds = torch.arange(n_ratings + 1, dtype=torch.int32, device=ratings.device)
    off = torch.searchsorted(key, bounds, out_int32=True)
    return order.to(torch.int32), off


def cross_splits(k: int, s: int, n_rows: int, n_ratings: int, plan: Plan, dev) -> int:
    """Pass 2's row splits per rating: ~8 blocks per SM over the grid, and
    at least one partial sum of rows a split."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = -(-k // plan.nk) * s * n_ratings
    return max(1, min(-(-n_rows // (n_ratings * 64)), -(-8 * n_sm // blocks)))


def estep_blocks(b: int, n_ratings: int) -> int:
    """Pass 1's blocks along x: a rating's rows cut into tiles of
    ESTEP_ROWS alone (the kernel launches ceil(B / 64) + R; the spare ones
    find no tile and return)."""
    return -(-b // ESTEP_ROWS) + n_ratings


def launch_buffers(s: int, b: int, k: int, n_ratings: int, plan: Plan, splits: int, dev):
    """The kernel's scratch: packed p [S, R, K, 2, K, KC]; the marginal
    streams [3, B, S*K] in rating order; pass 2's p * cross per row split,
    p_part [S, splits, K^3 R], and pass 1's sum w log D per block, ll_part
    [S, estep_blocks] (both zeroed: a block with no rows writes nothing);
    scale [S, B] and rowinfo [B, 4] (both in rating order)."""
    f32 = dict(dtype=torch.float32, device=dev)
    pk = torch.empty((s, n_ratings, k, 2, k, plan.kc), **f32)
    streams = torch.empty((3, b, s * k), **f32)
    p_part = torch.zeros((s, splits, k ** 3 * n_ratings), **f32)
    ll_part = torch.zeros((s, estep_blocks(b, n_ratings)), **f32)
    scale = torch.empty((s, b), **f32)
    rowinfo = torch.empty((b, 4), dtype=torch.int32, device=dev)
    return pk, streams, p_part, ll_part, scale, rowinfo


def sorted_slot_genes(triplets, ratings, order, n_ratings: int) -> torch.Tensor:
    """The gene id of each stream slot (pos * B + sorted position), -1 for
    the rows of a rating out of range (sorted last; no pass reads them)."""
    rows = order.long()
    g = triplets.index_select(0, rows)
    r = ratings.index_select(0, rows)
    ok = ((r >= 0) & (r < n_ratings)).unsqueeze(1)
    return torch.where(ok, g, torch.full_like(g, -1)).t().reshape(-1)


class StreamPlan(NamedTuple):
    """A call's row and slot order: the rating order of the rows and the
    gene-sorted plan of the streams' slots (slot pos * B + sorted position)
    in ``em_bd.plan_scatter``'s form, blocks of ``em_large_g.DEFAULT_WB``
    genes."""

    order: torch.Tensor    # int32 [B] sorted position -> row
    off: torch.Tensor      # int32 [R + 1] rating r at sorted positions off[r] ..
    perm: torch.Tensor     # int32 [3 B] stream slots, gene-sorted
    lid: torch.Tensor      # int32 [3 B] gene - block * wb of each sorted slot
    offsets: torch.Tensor  # int32 [Q + 1] CSR of the sorted slots per gene block


def stream_plan(triplets, ratings, n_ratings: int, n_genes: int) -> StreamPlan:
    """The :class:`StreamPlan` of these rows, on their device, with no
    value read back to the host: :func:`rating_order`, then
    ``em_large_g.device_scatter_plan`` of :func:`sorted_slot_genes`."""
    order, off = rating_order(ratings, n_ratings)
    genes = sorted_slot_genes(triplets, ratings, order, n_ratings)
    perm, lid, offsets = em_large_g.device_scatter_plan(genes, n_genes)
    return StreamPlan(order, off, perm, lid, offsets)


def fit_batch(ds, dev):
    """K3's fit batch: ``ds``'s rows on ``dev`` with their :class:`StreamPlan`."""
    batch = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    with span("fit.plan"):
        sp = stream_plan(batch.triplets, batch.ratings, ds.n_ratings, ds.n_genes)
    return (batch._replace(rating_order=sp.order, rating_offsets=sp.off, stream_perm=sp.perm,
                           stream_lid=sp.lid, stream_offsets=sp.offsets),
            {"plan_rows": int(sp.perm.shape[0])})


def batch_stream_plan(batch: Batch, n_ratings: int, n_genes: int) -> StreamPlan:
    """The batch's attached plan, else one built now for its rows."""
    if batch.rating_order is not None:
        return StreamPlan(batch.rating_order, batch.rating_offsets, batch.stream_perm,
                          batch.stream_lid, batch.stream_offsets)
    return stream_plan(batch.triplets, batch.ratings, n_ratings, n_genes)


def finish_sweep(streams, p_part, ll_part, plan: StreamPlan, ps,
                 n_genes: int) -> SweepStats:
    """The sweep's stats from the kernel's outputs, every sum in a fixed
    order: theta_hat as the plan scatter of the streams along the plan's
    gene-sorted slots, p_hat and loglik as the block sums of the
    partials."""
    S, K, R = ps.shape[0], ps.shape[1], ps.shape[-1]
    cells = K ** 3 * R
    p_hat, ll = block_sum.block_sum([
        block_sum.Segment(p_part, 0, cells),
        block_sum.Segment(ll_part.view(S, -1, 1), 0, 1)])
    theta_hat = em_bd.plan_scatter(streams, plan.perm, plan.lid, plan.offsets,
                                   em_large_g.DEFAULT_WB, n_genes, K)
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat.view(ps.shape), loglik=ll.view(S))


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
    if B == 0:
        return SweepStats(theta_hat=torch.zeros_like(thetas), p_hat=torch.zeros_like(ps),
                          loglik=torch.zeros(S, dtype=torch.float32, device=dev))
    sp = batch_stream_plan(batch, R, G)
    _build.require("rating_order", sp.order, torch.int32, (B,), dev)
    _build.require("rating_offsets", sp.off, torch.int32, (R + 1,), dev)
    splits = cross_splits(K, S, B, R, plan, dev)
    pk, streams, p_part, ll_part, scale, rowinfo = launch_buffers(S, B, K, R, plan, splits, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tip_em_sweep_large_k(
            thetas.data_ptr(), ps.data_ptr(), batch.triplets.data_ptr(),
            batch.weights.data_ptr(), sp.order.data_ptr(), sp.off.data_ptr(), pk.data_ptr(),
            streams.data_ptr(), p_part.data_ptr(), ll_part.data_ptr(), scale.data_ptr(),
            rowinfo.data_ptr(), S, B, G, K, R, plan.kc, plan.estep_threads,
            plan.estep_smem, plan.nk, splits, plan.vec, plan.cross_threads, plan.cross_smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, KERNEL_NAME)
    em_ensemble_stats.launches += 1
    return finish_sweep(streams, p_part, ll_part, sp, ps, G)


em_ensemble_stats.launches = 0
em_ensemble_stats.kernel_name = KERNEL_NAME
