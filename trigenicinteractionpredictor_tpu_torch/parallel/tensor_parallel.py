"""Tensor parallelism over the K^3 group tensor (counterpart of the
reference's ``parallel/tensor_parallel.py``).

For the large-K regime: p [S, K, K, K, R] and its statistic p_hat are split
on the ``l`` axis (dim 2) over ``model`` (the reference's
``TP_STATE_SPEC``), so each rank holds 1/M of every K^3 object; theta and
theta_hat stay whole on every rank of the axis.  The trigenic factorized
algebra of ``ops/em.py`` is re-partitioned on the l-block:

    T[b,k,lb] = sum_m th3[b,m] p_blk[k,lb,m,r_b]
    A1 = sum over model of sum_lb th2_blk T     A3 = sum over model of
    A2 = the blocks sum_k th1 T, joined         sum_{k,lb} th1 th2_blk p_blk

A1, A3 and A2 travel in one ``all_reduce`` over ``model`` of a [3, S, B, K]
buffer: A1 and A3 as partial sums, A2 as disjoint l-blocks in zeros (a
gather as an all_reduce, exact, and within what gloo runs on CUDA
tensors).  theta_hat then comes out the same on every model rank, p_hat as
this rank's block, and the (theta_hat, p_hat block, loglik) triple is
summed over ``data`` in one packed all_reduce, as in ``sharded_em.py``.

Plain PyTorch, no kernel, as the reference's TP sweep is plain jnp: p is
split, and the hand-written kernels take a whole p.  Trigenic (arity 3)
only.  Rows are taken ``row_chunk`` at a time (the engine's
``jnp_row_chunk``), one model all_reduce a chunk, which bounds the
[S, B, K, Kb, R] intermediate.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    _EPS,
    Batch,
    SweepStats,
    _gather,
    _row_chunks,
    _select_rating,
    normalize_from_stats,
    segment_rows,
)
from trigenicinteractionpredictor_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ENSEMBLE_AXIS,
    MODEL_AXIS,
    Mesh,
)
from trigenicinteractionpredictor_tpu_torch.parallel.sharded_em import (
    all_reduce_packed,
    block,
    gather_blocks,
    powered,
    reduce_stats,
)

P_L_DIM = 2  # p's l axis in [S, K, K, K, R]


def shard_tp_state(states: ModelState, mesh: Mesh) -> ModelState:
    """This rank's restarts (over ``ensemble``) and l-block of p (over
    ``model``)."""
    return ModelState(
        theta=block(states.theta, mesh, ENSEMBLE_AXIS),
        p=block(block(states.p, mesh, ENSEMBLE_AXIS), mesh, MODEL_AXIS, dim=P_L_DIM),
    )


def gather_tp_states(states: ModelState, mesh: Mesh) -> ModelState:
    """The full ``[S, ...]`` states on every rank."""
    p = gather_blocks(states.p, mesh, MODEL_AXIS, dim=P_L_DIM)
    return ModelState(theta=gather_blocks(states.theta, mesh, ENSEMBLE_AXIS),
                      p=gather_blocks(p, mesh, ENSEMBLE_AXIS))


def _tp_partials(theta, p_blk, batch: Batch, mesh: Mesh):
    """The per-row quantities of one row chunk: (th1, th2, th3, th2_blk, T),
    all [S, B, ...]."""
    S, _, K = theta.shape
    Kb, R = p_blk.shape[P_L_DIM], p_blk.shape[-1]
    B = batch.triplets.shape[0]
    lo = mesh.index(MODEL_AXIS) * Kb
    th1, th2, th3 = _gather(theta, batch.triplets)
    th2_blk = th2[..., lo:lo + Kb]
    p_m = p_blk.permute(0, 3, 1, 2, 4).reshape(S, K, K * Kb * R)
    T = _select_rating(torch.matmul(th3, p_m).reshape(S, B, K, Kb, R), batch.ratings, 1)
    return th1, th2, th3, th2_blk, T


def _tp_chunk_stats(theta, p_blk, batch: Batch, mesh: Mesh):
    """One row chunk's (theta_hat, p_hat block, loglik) on this rank."""
    S, _, K = theta.shape
    Kb, R = p_blk.shape[P_L_DIM], p_blk.shape[-1]
    B = batch.triplets.shape[0]
    lo = mesh.index(MODEL_AXIS) * Kb
    r = batch.ratings
    w = batch.weights.to(theta.dtype)
    th1, th2, th3, th2_blk, T = _tp_partials(theta, p_blk, batch, mesh)

    W_blk = (th1.unsqueeze(-1) * th2_blk.unsqueeze(-2)).reshape(S, B, K * Kb)
    A = theta.new_zeros((3, S, B, K))
    A[0] = torch.einsum("sbkl,sbl->sbk", T, th2_blk)                     # A1, partial
    A[1, ..., lo:lo + Kb] = torch.einsum("sbkl,sbk->sbl", T, th1)         # A2, own block
    A[2] = _select_rating(                                                # A3, partial
        torch.matmul(W_blk, p_blk.reshape(S, K * Kb, K * R)).reshape(S, B, K, R), r, 1)
    A1, A2, A3 = all_reduce_packed([A], mesh.group(MODEL_AXIS))[0]
    D = (th1 * A1).sum(-1)

    sc = (w / (D + _EPS)).unsqueeze(-1)
    theta_hat = segment_rows((th1 * A1 * sc, th2 * A2 * sc, th3 * A3 * sc), batch.triplets,
                             theta.shape[-2])
    onehot = torch.nn.functional.one_hot(r.long(), R).to(theta.dtype)
    th3r = (th3.unsqueeze(-1) * onehot.unsqueeze(-2)).reshape(S, B, K * R)
    cross = torch.matmul((W_blk * sc).transpose(-1, -2), th3r)          # [S, K*Kb, K*R]
    p_hat_blk = p_blk * cross.reshape(p_blk.shape)
    loglik = (w * torch.log(D + _EPS)).sum(-1)
    return theta_hat, p_hat_blk, loglik


def tp_local_stats(theta, p_blk, batch: Batch, mesh: Mesh, row_chunk: int = 0) -> SweepStats:
    """This rank's sufficient statistics with p split over ``model``
    (theta_hat whole, p_hat this rank's l-block), before the sum over
    ``data``."""
    chunks = (_row_chunks(batch, row_chunk)
              if row_chunk and batch.triplets.shape[0] > row_chunk else [batch])
    total = None
    for mb in chunks:
        part = _tp_chunk_stats(theta, p_blk, mb, mesh)
        total = part if total is None else [t.add_(x) for t, x in zip(total, part)]
    return SweepStats(*total)


def tp_step(
    states: ModelState,
    batch: Batch,
    degrees: torch.Tensor,
    mesh: Mesh,
    beta: Optional[float] = None,
    row_chunk: int = 0,
    buffers: Optional[Tuple] = None,
) -> Tuple[ModelState, torch.Tensor]:
    """One tensor-parallel EM sweep: ``(new states, loglik [S_local])``;
    ``beta`` anneals it as ``sharded_em.sharded_step`` does (elementwise
    powers commute with the l-split)."""
    src = states if beta is None else powered(states, beta, buffers)
    stats = reduce_stats(tp_local_stats(src.theta, src.p, batch, mesh, row_chunk), mesh)
    return normalize_from_stats(states, stats, degrees), stats.loglik


def tp_multi_step(
    states: ModelState,
    batch: Batch,
    degrees: torch.Tensor,
    mesh: Mesh,
    n_inner: int,
    betas: Optional[Sequence[float]] = None,
    row_chunk: int = 0,
) -> Tuple[ModelState, torch.Tensor]:
    """``n_inner`` chained TP sweeps: ``(states, ll_hist [n_inner,
    S_local])``, optionally annealed by ``betas``."""
    buffers = None if betas is None else (torch.empty_like(states.theta),
                                          torch.empty_like(states.p))
    lls = []
    for i in range(n_inner):
        states, ll = tp_step(states, batch, degrees, mesh,
                             None if betas is None else float(betas[i]), row_chunk, buffers)
        lls.append(ll)
    return states, torch.stack(lls)


def tp_likelihood(states: ModelState, batch: Batch, mesh: Mesh,
                  row_chunk: int = 0) -> torch.Tensor:
    """Per-restart log-likelihood ``[S_local]`` with p split over
    ``model``: D's partial sums over the l-block summed over ``model``."""
    chunks = (_row_chunks(batch, row_chunk)
              if row_chunk and batch.triplets.shape[0] > row_chunk else [batch])
    ll = 0
    for mb in chunks:
        th1, _, _, th2_blk, T = _tp_partials(states.theta, states.p, mb, mesh)
        D = torch.einsum("sbk,sbkl,sbl->sb", th1, T, th2_blk)
        D = all_reduce_packed([D], mesh.group(MODEL_AXIS))[0]
        ll = ll + (mb.weights.to(D.dtype) * torch.log(D + _EPS)).sum(-1)
    return all_reduce_packed([ll], mesh.group(DATA_AXIS))[0]
