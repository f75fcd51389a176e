"""The EM sweep in plain PyTorch (counterpart of the reference's
``ops/em.py``): the anchor every kernel of the port is held to.

Math, for one observation t = (i, j, e, r) (see the reference module):

    omega_t(k,l,m) = theta[i,k] theta[j,l] theta[e,m] p[k,l,m,r] / D_t
    D_t            = sum_{klm} theta[i,k] theta[j,l] theta[e,m] p[k,l,m,r]

Factorized so the per-row K^3 responsibility is never materialized:

    T[b,k,l]  = sum_m theta3[b,m] p[k,l,m,r_b]
    A1[b,k]   = sum_l theta2[b,l] T[b,k,l];   A2[b,l] = sum_k theta1[b,k] T[b,k,l]
    D[b]      = sum_k theta1[b,k] A1[b,k]
    A3[b,m]   = sum_kl theta1 theta2 p[k,l,m,r_b]
    theta_hat = scatter-add of theta_pos * A_pos * w/D by gene id
    p_hat     = p * ((theta1 theta2 w/D)^T @ (theta3 x onehot(r)))
    L         = sum_b w_b log D_b

Every function takes either one state (theta [G,K]) or a restart-stacked
ensemble (theta [S,G,K]); the leading axis rides through as a batch
dimension.  Weight-0 rows are inert.  On CUDA, float32 matmuls run in true
float32 (``device.resolve_device`` turns TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState

_EPS = 1e-30


class Batch(NamedTuple):
    """Device-side rows: int32/int64 triplets [B, arity], ratings [B] and
    float32 weights [B] (0 marks padding).

    The plan fields are None except on the large-G routes (the reference's
    ``Batch.scatter_*`` and ``g1_*``; see ``ops/em_large_g.py`` and
    ``ops/em_bdg.py``).  Unlike the reference's, the port's plans hold no
    pad slots and no per-tile tables: a gene-sorted slot order with CSR
    offsets per gene block.  ``tile_rating`` is the rating of each tile of
    rating-sorted rows (``ops/em_rsorted.py``), the reference's field of
    that name.  The ``rating_*`` and ``stream_*`` fields are K3's plan, a
    classic fit's once (``ops/em_large_k.py::StreamPlan``; the reference
    has none): the rows' rating order, and the gene-sorted plan of the
    marginal streams the kernel writes in that order, in the form of the
    ``scatter_*`` fields.
    """

    triplets: torch.Tensor
    ratings: torch.Tensor
    weights: torch.Tensor
    scatter_perm: Optional[torch.Tensor] = None     # int32 [P*B] slots, gene-sorted
    scatter_lid: Optional[torch.Tensor] = None      # int32 [P*B] gene - block * wb
    scatter_offsets: Optional[torch.Tensor] = None  # int32 [Q+1] CSR per gene block
    g1_lid: Optional[torch.Tensor] = None           # int32 [B] g1 - block * wb1
    g1_offsets: Optional[torch.Tensor] = None       # int32 [Q1+1] CSR of rows
    tile_rating: Optional[torch.Tensor] = None      # int32 [n_tiles]
    rating_order: Optional[torch.Tensor] = None     # int32 [B] rows stably sorted by rating
    rating_offsets: Optional[torch.Tensor] = None   # int32 [R+1] rating r at [off[r], off[r+1])
    stream_perm: Optional[torch.Tensor] = None      # int32 [3B] stream slots, gene-sorted
    stream_lid: Optional[torch.Tensor] = None       # int32 [3B] gene - block * wb
    stream_offsets: Optional[torch.Tensor] = None   # int32 [Q+1] CSR per gene block


class SweepStats(NamedTuple):
    """Unnormalized sufficient statistics of one sweep (leading [S] on the
    ensemble form)."""

    theta_hat: torch.Tensor  # f32 [..., G, K]
    p_hat: torch.Tensor      # f32 [..., K, ..., K, R]
    loglik: torch.Tensor     # f32 [...] -- L of the *pre-update* state


def make_batch(triplets, ratings, weights, device, scatter=None, g1=None,
               tile_rating=None) -> Batch:
    """Host arrays -> a contiguous device Batch (int32 ids, as the kernels
    take them).  ``scatter`` (a ScatterPlan) and ``g1`` (a G1Plan, rows
    already in its order) attach the large-G plans; ``tile_rating`` (rows
    already rating-sorted) the tile table."""

    def dev_i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=device).contiguous()

    plans = {}
    if scatter is not None:
        plans.update(scatter_perm=dev_i32(scatter.perm), scatter_lid=dev_i32(scatter.lid),
                     scatter_offsets=dev_i32(scatter.offsets))
    if g1 is not None:
        plans.update(g1_lid=dev_i32(g1.lid1), g1_offsets=dev_i32(g1.offsets))
    if tile_rating is not None:
        plans.update(tile_rating=dev_i32(tile_rating))
    return Batch(
        triplets=dev_i32(triplets),
        ratings=dev_i32(ratings),
        weights=torch.as_tensor(weights, dtype=torch.float32, device=device).contiguous(),
        **plans,
    )


def _gather(theta: torch.Tensor, triplets: torch.Tensor):
    """Per-position theta rows: one [..., B, K] tensor per gene slot."""
    idx = triplets.long()
    return tuple(theta[..., idx[:, pos], :] for pos in range(idx.shape[1]))


def _select_rating(x: torch.Tensor, r: torch.Tensor, row_dim: int) -> torch.Tensor:
    """x[..., b, ..., r_b] with rows on ``row_dim``: squeeze the rating axis."""
    shape = [1] * x.dim()
    shape[row_dim] = r.shape[0]
    idx = r.long().view(shape)
    return torch.take_along_dim(x, idx, dim=-1).squeeze(-1)


def segment_rows(vals, genes: torch.Tensor, n_genes: int) -> torch.Tensor:
    """sum over slots of vals[p][..., b, :] into [..., n_genes, K] rows by
    gene id ``genes`` [B, P] (slot (p, b) to gene genes[b, p]), each gene's
    slots summed in slot order, position-major.  A stable sort of the ids
    and one segment sum: the order of every sum is fixed by the ids, on
    the CPU and on CUDA alike (``index_add_`` sums with atomics on CUDA, in
    an order that changes from run to run).  On the CPU it sums in
    ``index_add_``'s order.  Ids must lie in [0, n_genes)."""
    lead, K = vals[0].shape[:-2], vals[0].shape[-1]
    ids = genes.long().t().reshape(-1)
    order = torch.argsort(ids, stable=True)
    counts = torch.bincount(ids, minlength=n_genes)
    rows = torch.cat([v.movedim(-2, 0).reshape(v.shape[-2], -1) for v in vals])
    out = torch.segment_reduce(rows.index_select(0, order), "sum", lengths=counts,
                               axis=0, unsafe=True)
    return out.reshape((n_genes,) + tuple(lead) + (K,)).movedim(0, -2)


def _row_chunks(batch: Batch, row_chunk: int):
    """The batch as consecutive slices of at most ``row_chunk`` rows."""
    B = batch.triplets.shape[0]
    rows = (batch.triplets, batch.ratings, batch.weights)
    return [Batch(*(x[i : i + row_chunk] for x in rows)) for i in range(0, B, row_chunk)]


def em_sufficient_stats(theta, p, batch: Batch, row_chunk: int = 0) -> SweepStats:
    """E-step + M-accumulate over one batch (no normalization).

    Dispatches on the tuple width: arity 3 below, arity 2 (the digenic
    family, p[..., K, K, R]) in :func:`pair_em_sufficient_stats`.
    ``row_chunk`` > 0 sums the statistics of either arity over chunks of
    that many rows (the reference's ``row_chunk``): exact, since every
    statistic is a sum over rows, and it bounds the [..., B, K^2 R]
    intermediates by the chunk.
    """
    if row_chunk and batch.triplets.shape[0] > row_chunk:
        chunks = iter(_row_chunks(batch, row_chunk))
        acc = em_sufficient_stats(theta, p, next(chunks))
        for mb in chunks:
            for total, part in zip(acc, em_sufficient_stats(theta, p, mb)):
                total.add_(part)
        return acc
    if batch.triplets.shape[1] == 2:
        return pair_em_sufficient_stats(theta, p, batch)
    vals, p_hat, loglik = position_marginals(theta, p, batch)
    theta_hat = segment_rows(vals, batch.triplets, theta.shape[-2])
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=loglik)


def position_marginals(theta, p, batch: Batch, cross_sum=None):
    """The arity-3 sweep without its theta_hat scatter: (the three per-row
    position marginals th_pos * A_pos * w/D, each [..., B, K]; p_hat; L).
    The large-G routes scatter the marginals through their plans."""
    return rows_marginals(*_gather(theta, batch.triplets), p, batch.ratings, batch.weights,
                          cross_sum)


def rows_marginals(th1, th2, th3, p, ratings, weights, cross_sum=None):
    """:func:`position_marginals` on theta rows already gathered per
    position (each [..., B, K]).  ``cross_sum(V, X)`` sums the cross-stats
    V^T X over the rows ([..., B, K^2] and [..., B, K R] to [..., K^2, K R])
    in place of the matmul."""
    K = th1.shape[-1]
    R = p.shape[-1]
    lead = th1.shape[:-2]
    B = th1.shape[-2]
    rd = len(lead)  # row axis of the per-row tensors
    r = ratings
    w = weights.to(th1.dtype)

    # T_all[..., b, k, l, r] = sum_m th3[b, m] p[k, l, m, r]
    p_m = p.movedim(-2, -4).reshape(lead + (K, K * K * R))
    T = _select_rating(
        torch.matmul(th3, p_m).reshape(lead + (B, K, K, R)), r, rd
    )
    A1 = torch.einsum("...bkl,...bl->...bk", T, th2)
    A2 = torch.einsum("...bkl,...bk->...bl", T, th1)
    D = (th1 * A1).sum(-1)
    W = (th1.unsqueeze(-1) * th2.unsqueeze(-2)).reshape(lead + (B, K * K))
    A3 = _select_rating(
        torch.matmul(W, p.reshape(lead + (K * K, K * R))).reshape(lead + (B, K, R)),
        r, rd,
    )

    scale = w / (D + _EPS)
    sc = scale.unsqueeze(-1)
    vals = (th1 * A1 * sc, th2 * A2 * sc, th3 * A3 * sc)

    V = W * sc                                                   # [..., B, K^2]
    onehot = torch.nn.functional.one_hot(r.long(), R).to(th1.dtype)  # [B, R]
    th3r = (th3.unsqueeze(-1) * onehot.unsqueeze(-2)).reshape(lead + (B, K * R))
    cross = (torch.matmul(V.transpose(-1, -2), th3r) if cross_sum is None
             else cross_sum(V, th3r))                            # [..., K^2, K*R]
    p_hat = p * cross.reshape(p.shape)

    loglik = (w * torch.log(D + _EPS)).sum(-1)
    return vals, p_hat, loglik


def pair_em_sufficient_stats(theta, p, batch: Batch) -> SweepStats:
    """Arity-2 sweep stats (digenic family): p is [..., K, K, R].

        A1[b,k] = sum_l theta2[b,l] p[k,l,r_b];  A2[b,l] = sum_k theta1[b,k] p[k,l,r_b]
        D[b]    = sum_k theta1[b,k] A1[b,k]
        p_hat   = p * sum_{b: r_b=r} theta1 theta2 w/D
    """
    K = theta.shape[-1]
    R = p.shape[-1]
    lead = theta.shape[:-2]
    B = batch.triplets.shape[0]
    rd = len(lead)
    r = batch.ratings
    w = batch.weights.to(theta.dtype)

    th1, th2 = _gather(theta, batch.triplets)
    p_l = p.transpose(-3, -2).reshape(lead + (K, K * R))
    A1 = _select_rating(torch.matmul(th2, p_l).reshape(lead + (B, K, R)), r, rd)
    A2 = _select_rating(
        torch.matmul(th1, p.reshape(lead + (K, K * R))).reshape(lead + (B, K, R)),
        r, rd,
    )
    D = (th1 * A1).sum(-1)

    scale = w / (D + _EPS)
    sc = scale.unsqueeze(-1)
    theta_hat = segment_rows((th1 * A1 * sc, th2 * A2 * sc), batch.triplets, theta.shape[-2])

    onehot = torch.nn.functional.one_hot(r.long(), R).to(theta.dtype)
    th2r = (th2.unsqueeze(-1) * onehot.unsqueeze(-2)).reshape(lead + (B, K * R))
    cross = torch.matmul((th1 * sc).transpose(-1, -2), th2r)     # [..., K, K*R]
    p_hat = p * cross.reshape(p.shape)

    loglik = (w * torch.log(D + _EPS)).sum(-1)
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=loglik)


def normalize_from_stats(
    state: ModelState,
    stats: SweepStats,
    degrees: torch.Tensor,
    theta_norm: str = "degree",
) -> ModelState:
    """M-step normalization.

    theta rows divide by the gene's training degree d(g) (``"degree"``) or
    by their own sum (``"rowsum"``); rows with a zero divisor keep their old
    value.  p cells normalize over ratings; cells with no mass (<= _EPS)
    keep their old value.
    """
    if theta_norm == "rowsum":
        denom = stats.theta_hat.sum(-1)
    elif theta_norm == "degree":
        denom = degrees.to(state.theta.dtype)
    else:
        raise ValueError(f"unknown theta_norm {theta_norm!r}")
    theta_new = stats.theta_hat / torch.clamp(denom, min=_EPS).unsqueeze(-1)
    theta = torch.where((denom > 0).unsqueeze(-1), theta_new, state.theta)

    p_mass = stats.p_hat.sum(-1, keepdim=True)
    p = torch.where(p_mass > _EPS, stats.p_hat / (p_mass + _EPS), state.p)
    return ModelState(theta=theta, p=p)


def em_step(state: ModelState, batch: Batch, degrees: torch.Tensor):
    """One full EM sweep: (new_state, loglik of the *old* state)."""
    stats = em_sufficient_stats(state.theta, state.p, batch)
    return normalize_from_stats(state, stats, degrees), stats.loglik


def log_likelihood(state: ModelState, batch: Batch, row_chunk: int = 0):
    """Weighted sum_b w_b log P(r_b | genes) under ``state`` (both arities).

    ``row_chunk`` > 0 sums over row chunks (exact: L is additive over rows),
    bounding the [.., B, K^2 R] intermediate.
    """
    B = batch.triplets.shape[0]
    if row_chunk and B > row_chunk:
        return sum(log_likelihood(state, mb) for mb in _row_chunks(batch, row_chunk))
    theta, p = state.theta, state.p
    K = theta.shape[-1]
    R = p.shape[-1]
    lead = theta.shape[:-2]
    rd = len(lead)
    w = batch.weights.to(theta.dtype)
    if batch.triplets.shape[1] == 2:
        th1, th2 = _gather(theta, batch.triplets)
        p_l = p.transpose(-3, -2).reshape(lead + (K, K * R))
        A1 = _select_rating(
            torch.matmul(th2, p_l).reshape(lead + (B, K, R)), batch.ratings, rd
        )
        D = (th1 * A1).sum(-1)
        return (w * torch.log(D + _EPS)).sum(-1)
    th1, th2, th3 = _gather(theta, batch.triplets)
    p_m = p.movedim(-2, -4).reshape(lead + (K, K * K * R))
    T = _select_rating(
        torch.matmul(th3, p_m).reshape(lead + (B, K, K, R)), batch.ratings, rd
    )
    D = torch.einsum("...bk,...bkl,...bl->...b", th1, T, th2)
    return (w * torch.log(D + _EPS)).sum(-1)
