"""K7: the EM sweep kernel on pre-gathered theta rows (``csrc/em_hybrid.cu``)
and its wrapper (counterpart of the reference's ``ops/pallas_em_hybrid.py``:
``hybrid_em_ensemble_stats`` and ``_pallas_stats_hybrid``).

The kernel's contract is the reference's: the theta rows of each position
come in pre-gathered as streams ``th1, th2, th3`` [B, S*K] (``th_pos[b,
s*K + k] = thetas[s, triplets[b, pos], k]``, the reference's ``jnp.take``
of its [G, S*K] theta), with the triplets [B, 3] int32 (for the scatter),
ratings [B] int32, weights [B] float32 and ``ps`` [S,K,K,K,R]; out comes
the :class:`SweepStats` of one sweep, every sum in an order fixed by the
rows (K3's ``finish_sweep``: the kernel's marginal streams through the plan
scatter, its partials through the block sum).

- :func:`gather_rows` builds the streams (a plain ``index_select``, as the
  reference gathers outside its kernel);
- :func:`hybrid_stats` is the kernel's wrapper: on a CPU tensor it runs
  the plain version, :func:`em_ensemble_stats_reference` (the per-row
  algebra of ``ops/em.py`` plus ``segment_rows``); on a CUDA tensor it
  launches the kernel or raises;
- :func:`em_ensemble_stats` is the route's stats function (K1's signature:
  thetas, ps, batch): gather, then :func:`hybrid_stats`.

The kernel is K3's two passes with the row load taken from the streams
(``csrc/em_large_k.cuh``), so it takes K3's range (21 <= K <= 72, R <= 3)
and K3's launch plan; any G, S <= 65535, any B (no tile multiple, no pad
rows).  Exact float32 in both engine precision modes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from trigenicinteractionpredictor_tpu_torch.ops import _build, em_large_k
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    Batch,
    SweepStats,
    rows_marginals,
    segment_rows,
)

KERNEL_NAME = "cuda-em-hybrid"
DEFAULT_ROW_CHUNK = em_large_k.DEFAULT_ROW_CHUNK


def gather_rows(thetas, triplets) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The streams th1, th2, th3 [B, S*K] of ``thetas`` [S,G,K] at the
    three positions of ``triplets``.  Out-of-range ids read gene 0 (the
    kernel treats those rows as inert; callers check ids on the host)."""
    S, G, K = thetas.shape
    theta_all = thetas.transpose(0, 1).reshape(G, S * K)
    idx = triplets.long()
    idx = torch.where((idx >= 0) & (idx < G), idx, torch.zeros_like(idx))
    return tuple(theta_all.index_select(0, idx[:, pos]) for pos in range(3))


def em_ensemble_stats_reference(
    th1, th2, th3, triplets, ratings, weights, ps, n_genes: int,
    row_chunk: int = DEFAULT_ROW_CHUNK,
) -> SweepStats:
    """The plain version on the same pre-gathered inputs: the per-row
    algebra of ``ops/em.py`` (:func:`rows_marginals`) over chunks of
    ``row_chunk`` rows (0: one chunk), scattered by ``segment_rows``."""
    S, K = ps.shape[0], ps.shape[1]
    B = th1.shape[0]
    theta_hat = th1.new_zeros((S, n_genes, K))
    p_hat = torch.zeros_like(ps)
    loglik = th1.new_zeros((S,))
    step = row_chunk or max(B, 1)
    for lo in range(0, B, step):
        sl = slice(lo, lo + step)
        rows = [t[sl].reshape(-1, S, K).transpose(0, 1) for t in (th1, th2, th3)]
        vals, ph, ll = rows_marginals(*rows, ps, ratings[sl], weights[sl])
        theta_hat += segment_rows(vals, triplets[sl], n_genes)
        p_hat += ph
        loglik += ll
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=loglik)


def hybrid_stats(th1, th2, th3, triplets, ratings, weights, ps, n_genes: int) -> SweepStats:
    """One whole-ensemble sweep from the streams: theta_hat [S,G,K], p_hat
    [S,K,K,K,R] and loglik [S] of the pre-update states."""
    if th1.device.type == "cpu":
        return em_ensemble_stats_reference(
            th1, th2, th3, triplets, ratings, weights, ps, n_genes)
    S, K = ps.shape[0], ps.shape[1]
    R = ps.shape[-1]
    B, G = th1.shape[0], n_genes
    dev = th1.device
    for name, t in (("th1", th1), ("th2", th2), ("th3", th3)):
        _build.require(name, t, torch.float32, (B, S * K), dev)
    _build.require("ps", ps, torch.float32, (S, K, K, K, R), dev)
    _build.require("triplets", triplets, torch.int32, (B, 3), dev)
    _build.require("ratings", ratings, torch.int32, (B,), dev)
    _build.require("weights", weights, torch.float32, (B,), dev)
    plan = em_large_k.sweep_plan(K, R)
    if plan is None:
        raise ValueError(f"{KERNEL_NAME} does not take K={K}, R={R} (K must be "
                         f"{em_large_k.MIN_K}..{em_large_k.MAX_K}, R at most "
                         f"{em_large_k.MAX_RATINGS})")
    if S > 65535:
        raise ValueError(f"{KERNEL_NAME} takes at most 65535 restarts, got {S}")
    if B == 0:
        return SweepStats(theta_hat=torch.zeros((S, G, K), dtype=torch.float32, device=dev),
                          p_hat=torch.zeros_like(ps),
                          loglik=torch.zeros(S, dtype=torch.float32, device=dev))
    order, off = em_large_k.rating_order(ratings, R)
    splits = em_large_k.cross_splits(K, S, B, R, plan, dev)
    pk, streams, p_part, ll_part, scale, rowinfo = em_large_k.launch_buffers(
        S, B, K, R, plan, splits, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tip_em_hybrid(
            th1.data_ptr(), th2.data_ptr(), th3.data_ptr(), ps.data_ptr(),
            triplets.data_ptr(), weights.data_ptr(), order.data_ptr(), off.data_ptr(),
            pk.data_ptr(), streams.data_ptr(), p_part.data_ptr(), ll_part.data_ptr(),
            scale.data_ptr(), rowinfo.data_ptr(), S, B, G, K, R, plan.kc,
            plan.estep_threads, plan.estep_smem, plan.nk, splits, plan.vec,
            plan.cross_threads,
            plan.cross_smem, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, KERNEL_NAME)
    hybrid_stats.launches += 1
    return em_large_k.finish_sweep(streams, p_part, ll_part, triplets, ratings, order, ps, G)


hybrid_stats.launches = 0
hybrid_stats.kernel_name = KERNEL_NAME


def em_ensemble_stats(thetas, ps, batch: Batch) -> SweepStats:
    """The route's stats function: thetas [S,G,K], ps [S,K,K,K,R] and a
    batch in, the sweep's :class:`SweepStats` out, through K7."""
    th1, th2, th3 = gather_rows(thetas, batch.triplets)
    return hybrid_stats(th1, th2, th3, batch.triplets, batch.ratings,
                        batch.weights, ps, thetas.shape[1])


em_ensemble_stats.kernel_name = KERNEL_NAME
