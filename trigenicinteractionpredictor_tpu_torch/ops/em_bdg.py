"""K4: the bdg sweep of the large-G routes (counterpart of the reference's
``ops/pallas_em_bdg.py``: ``G1Plan``, ``make_g1_plan``,
``apply_g1_order``, ``_bdg_estep`` and ``bdg_em_ensemble_stats``).

Rows go in the order of a g1 plan (stably sorted by the gene block of
position 1), so :func:`bdg_estep` (``csrc/em_bdg.cu``) sums position 1's
theta_hat share one gene block at a time in shared memory, in tiles of
rows of up to two gene blocks (:func:`bdg_tile_census` counts them).
Positions 2 and 3 leave the E-step as streams [2, B, S*K] and reach
theta_hat through ``ops/em_bd.py::plan_scatter`` with a 2-position
scatter plan built on the reordered rows.

The port's g1 plan drops the reference's rule that pads every block's run
of rows to a whole tile (``pallas_em_bdg.py:101-110``; 91% pad rows at
G = 500,000): rows and CSR offsets per block, no pad rows.  The plain
version takes position 1's gene ids from the plan (block * wb1 + lid), not
from the triplets, so a wrong plan fails on the CPU too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.ops import _build, block_sum, em_bd, em_bdr
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    Batch,
    SweepStats,
    make_batch,
    position_marginals,
    segment_rows,
)
from trigenicinteractionpredictor_tpu_torch.ops.em_large_g import _check_ids, device_scatter_plan
from trigenicinteractionpredictor_tpu_torch.utils.tracing import span

KERNEL_NAME = "cuda-em-bdg"
ESTEP_NAME = "cuda-em-bdg-estep"
WB1_CHOICES = (512, 256, 128, 64, 32)  # gene-block widths, widest first
DEFAULT_WB1 = WB1_CHOICES[0]
_BLOCKS_PER_SM = 8


class G1Plan(NamedTuple):
    """Host-side row order for position-1-block-local rows."""

    order: np.ndarray    # int32 [B] row permutation
    lid1: np.ndarray     # int32 [B] g1 - block * wb1, in plan order
    offsets: np.ndarray  # int32 [Q1+1] CSR: block q holds plan rows [off[q], off[q+1])
    n_blocks: int        # Q1 = ceil(G / wb1)
    wb1: int


def make_g1_plan(triplets, n_genes: int, wb1: int = DEFAULT_WB1) -> G1Plan:
    """Stable sort of the rows by position-1 gene block, with CSR offsets
    per block (no pad rows)."""
    g1 = np.asarray(triplets)[:, 0]
    _check_ids(g1, n_genes)
    order = np.argsort(g1 // wb1, kind="stable")
    g_sorted = g1[order]
    n_blocks = -(-n_genes // wb1)
    offsets = np.zeros(n_blocks + 1, np.int64)
    np.cumsum(np.bincount(g_sorted // wb1, minlength=n_blocks), out=offsets[1:])
    return G1Plan(
        order=order.astype(np.int32),
        lid1=(g_sorted % wb1).astype(np.int32),
        offsets=offsets.astype(np.int32),
        n_blocks=n_blocks,
        wb1=wb1,
    )


def apply_g1_order(plan: G1Plan, triplets, ratings, weights):
    """The row arrays in the plan's order."""
    return (np.asarray(triplets)[plan.order], np.asarray(ratings)[plan.order],
            np.asarray(weights)[plan.order])


def device_g1_order(batch: Batch, n_genes: int, wb1: int = DEFAULT_WB1) -> Batch:
    """:func:`make_g1_plan` and :func:`apply_g1_order` on the batch's
    device: its rows stably sorted by position-1 gene block, carrying the
    plan's local ids and CSR offsets.  The same plan as the host's (a
    stable sort has one result), with no value read back to the host."""
    key, order = torch.sort(batch.triplets[:, 0] // wb1, stable=True)
    trip = batch.triplets[order]
    starts = torch.arange(-(-n_genes // wb1) + 1, dtype=key.dtype, device=key.device)
    return batch._replace(triplets=trip, ratings=batch.ratings[order],
                          weights=batch.weights[order], g1_lid=(trip[:, 0] % wb1).contiguous(),
                          g1_offsets=torch.searchsorted(key, starts, out_int32=True))


def fit_batch(ds, dev, wb1: int = DEFAULT_WB1, wb: int = em_bd.DEFAULT_WB,
              resident: Optional[int] = None):
    """K4's fit batch: ``ds``'s rows on ``dev`` in g1 order with a
    2-position scatter plan of the reordered rows, built there (the plans
    :func:`make_g1_plan` and ``make_scatter_plan`` give).  Its plan info
    records ``resident``, K4's blocks an SM at the plan that runs
    (:func:`bdg_resident`), beside ``wb1``."""
    batch = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    with span("fit.plan"):
        with span("fit.plan.g1"):
            batch = device_g1_order(batch, ds.n_genes, wb1)
        with span("fit.plan.scatter"):
            # K4 keeps position 1 in its E-step: slots of positions 2 and 3.
            slots = batch.triplets[:, 1:].T.reshape(-1)
            perm, lid, offsets = device_scatter_plan(slots, ds.n_genes, wb)
    return (batch._replace(scatter_perm=perm, scatter_lid=lid, scatter_offsets=offsets),
            {"wb": wb, "wb1": wb1, "resident": resident, "g1_blocks": -(-ds.n_genes // wb1),
             "plan_rows": int(perm.shape[0])})


def _smem_bytes(k: int, n_ratings: int, tile: int, wb1: int) -> int:
    """K1's tile buffers (``csrc/em_row_estep.cuh`` carve, which K4 shares:
    ``em_bdr.sweep_smem_bytes``) plus the two accumulator slots of a tile's
    gene blocks, [wb1, K] each, at the carve's end."""
    return em_bdr.sweep_smem_bytes(k, n_ratings, tile) + 8 * wb1 * k


def _tile(k: int, n_ratings: int, wb1: int) -> Optional[int]:
    """The largest row tile whose buffers fit one block's shared memory."""
    for tile in em_bdr.TILES:
        if _smem_bytes(k, n_ratings, tile, wb1) <= em_bdr.SMEM_LIMIT:
            return tile
    return None


def _resident(k: int, n_ratings: int, smem: int) -> int:
    """Blocks of K4's instance for (K, R) one SM holds at ``smem`` bytes
    each: its launch bound, which is K1's (``em_bdr.sweep_resident``: 4 at
    K = 10, R = 2, else 3), or what the SM's shared memory holds, the
    fewer."""
    return em_bdr.sweep_resident(k, n_ratings, smem)


def bdg_plan(k: int, n_ratings: int) -> Optional[Tuple[int, int]]:
    """(row tile, wb1) of the kernel at this (K, R): the largest tile that
    fits, then the widest gene block at which an SM holds as many blocks as
    the tile buffers alone give under the instance's launch bound (else the
    widest that fits); None outside K1's range.  A pure function of (K, R)
    and the card.  At K = 10, R = 2 that is four blocks an SM at wb1 = 64;
    the H100 A/B at the G = 100,000 cell's rows (PERF.md, section 6) ran
    it faster than three blocks an SM at wb1 = 128 or 256."""
    if em_bdr.sweep_plan(k, n_ratings) is None:
        return None
    for tile in em_bdr.TILES:
        base = _smem_bytes(k, n_ratings, tile, 0)
        if base > em_bdr.SMEM_LIMIT:
            continue
        fits = [w for w in WB1_CHOICES
                if _smem_bytes(k, n_ratings, tile, w) <= em_bdr.SMEM_LIMIT]
        keep = [w for w in fits
                if _resident(k, n_ratings, _smem_bytes(k, n_ratings, tile, w))
                >= _resident(k, n_ratings, base)]
        if keep or fits:
            return tile, (keep or fits)[0]
    return None


def bdg_resident(k: int, n_ratings: int) -> int:
    """K4's blocks an SM at :func:`bdg_plan`'s plan for (K, R)."""
    tile, wb1 = bdg_plan(k, n_ratings)
    return _resident(k, n_ratings, _smem_bytes(k, n_ratings, tile, wb1))


class TileCensus(NamedTuple):
    """K4's tiles of one restart over a g1 plan."""

    tiles: int     # tiles a restart
    crossing: int  # of them, tiles that hold rows of two gene blocks
    cut: int       # of them, tiles cut short by the second block's end


def bdg_tile_census(offsets, n_rows: int, piece_rows: int, tile: int) -> TileCensus:
    """The tiles :func:`bdg_estep` runs a restart over the rows of a g1
    plan's CSR ``offsets`` (``G1Plan.offsets``), under the kernel's rule
    (``csrc/em_bdg.cu``): each piece of ``piece_rows`` rows
    (:func:`bdg_pieces`) is cut into tiles of up to ``tile`` consecutive
    rows, each cut only at the piece's end or at the end of the second gene
    block it touches.  A pure host function: the fit does not call it."""
    off = np.asarray(offsets, np.int64)
    n_blocks = off.size - 1
    tiles = crossing = cut = 0
    for r0 in range(0, n_rows, piece_rows):
        r1 = min(n_rows, r0 + piece_rows)
        qa = int(np.searchsorted(off[:n_blocks], r0, side="right")) - 1
        row0 = r0
        while row0 < r1:
            while off[qa + 1] <= row0:
                qa += 1
            ea, e = off[qa + 1], min(row0 + tile, r1)
            if e > ea:
                qb = qa + 1
                while off[qb + 1] <= ea:
                    qb += 1
                crossing += 1
                if off[qb + 1] < e:
                    e = int(off[qb + 1])
                    cut += 1
            tiles += 1
            row0 = e
    return TileCensus(tiles, crossing, cut)


def bdg_pieces(n_rows: int, n_samples: int, tile: int, n_sm: int) -> Tuple[int, int]:
    """(rows per piece, pieces): pieces of whole tiles for ~8 blocks an SM
    across the S restarts.  A pure function of the rows, S, the tile and
    the card's SM count, so on one card it fixes the order of every sum."""
    n_tiles = -(-n_rows // tile)
    pieces = max(1, min(n_tiles, -(-_BLOCKS_PER_SM * n_sm // n_samples)))
    piece_rows = -(-n_tiles // pieces) * tile
    return piece_rows, -(-n_rows // piece_rows)


def bdg_buffers(pieces: int, s: int, k: int, n_ratings: int, wb1: int, dev):
    """The kernel's partials: part_th [pieces, 2, S, wb1 K] (each piece's
    head and tail gene block, position 1's share) and part_p [S, pieces,
    K^3 R + 1] (each block's p * cross and sum w log D).  Every value the
    kernels read is written first, so neither needs zeroing."""
    part_th = torch.empty((pieces, 2, s, wb1 * k), dtype=torch.float32, device=dev)
    part_p = torch.empty((s, pieces, k ** 3 * n_ratings + 1), dtype=torch.float32, device=dev)
    return part_th, part_p


def require_g1_plan(batch: Batch) -> None:
    if batch.g1_lid is None or batch.g1_offsets is None:
        raise ValueError(
            f"{KERNEL_NAME} needs a g1 plan on the batch (rows in "
            "make_g1_plan order; make_batch(..., g1=plan)) and a 2-position "
            "scatter plan of those rows (make_scatter_plan(positions=(1, 2)))"
        )
    em_bd.require_plan(batch, KERNEL_NAME)


def tile_ordered_cross(v, x, max_elems: int = 1 << 25):
    """v^T x over the rows ([..., B, I] and [..., B, J] to [..., I, J]),
    summed over tiles of 64 consecutive rows, each tile's rows in row
    order, then the tiles in order, as the kernel orders its sums: products
    and adds of whole tensors only, so the order of every sum, and the bits,
    do not depend on the CPU (a CPU matmul's order depends on the BLAS's
    code path for the CPU).  Tiles go in groups of at most ``max_elems``
    partial sums."""
    lead, B, I, J = v.shape[:-2], v.shape[-2], v.shape[-1], x.shape[-1]
    tile = em_bdr.TILES[0]
    n_tiles = -(-B // tile)
    pad = n_tiles * tile - B  # zero rows add exact zeros
    v = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(lead + (n_tiles, tile, I, 1))
    x = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(lead + (n_tiles, tile, 1, J))
    out = torch.zeros(lead + (I, J), dtype=v.dtype, device=v.device)
    per = max(1, max_elems // max(1, v[..., 0, 0, :, :].numel() * J))
    for t0 in range(0, n_tiles, per):
        part = v[..., t0:t0 + per, 0, :, :] * x[..., t0:t0 + per, 0, :, :]
        for i in range(1, tile):
            part += v[..., t0:t0 + per, i, :, :] * x[..., t0:t0 + per, i, :, :]
        for j in range(part.shape[-3]):
            out += part[..., j, :, :]
    return out


def bdg_estep_reference(thetas, ps, batch: Batch, wb1: int = DEFAULT_WB1):
    """The plain version of :func:`bdg_estep`, its cross-stats summed by
    :func:`tile_ordered_cross`."""
    S, G, K = thetas.shape
    gene1 = em_bd._plan_genes(batch.g1_lid, batch.g1_offsets, wb1)
    trip = torch.stack([gene1.to(batch.triplets.dtype), batch.triplets[:, 1],
                        batch.triplets[:, 2]], dim=1)
    vals, p_hat, loglik = position_marginals(thetas, ps, batch._replace(triplets=trip),
                                             tile_ordered_cross)
    theta_hat = segment_rows(vals[:1], gene1.unsqueeze(1), G)
    return em_bd.stack_streams(vals[1:]), theta_hat, p_hat, loglik


def bdg_estep(thetas, ps, batch: Batch, wb1: int = DEFAULT_WB1):
    """(streams [2, B, S*K] of positions 2 and 3; theta_hat [S,G,K] holding
    position 1's share; p_hat; loglik) of one sweep over g1-ordered rows."""
    if thetas.device.type == "cpu":
        return bdg_estep_reference(thetas, ps, batch, wb1)
    S, G, K = thetas.shape
    R = ps.shape[-1]
    B = batch.triplets.shape[0]
    Q1 = -(-G // wb1)
    dev = thetas.device
    _build.require("thetas", thetas, torch.float32, (S, G, K), dev)
    _build.require("ps", ps, torch.float32, (S, K, K, K, R), dev)
    _build.require("triplets", batch.triplets, torch.int32, (B, 3), dev)
    _build.require("ratings", batch.ratings, torch.int32, (B,), dev)
    _build.require("weights", batch.weights, torch.float32, (B,), dev)
    _build.require("g1_lid", batch.g1_lid, torch.int32, (B,), dev)
    _build.require("g1_offsets", batch.g1_offsets, torch.int32, (Q1 + 1,), dev)
    tile = _tile(K, R, wb1) if em_bdr.sweep_plan(K, R) is not None else None
    if tile is None:
        raise ValueError(f"{ESTEP_NAME} does not take K={K}, R={R}, wb1={wb1} "
                         f"(K must be 1..{em_bdr.MAX_K} and p[s] and two [wb1, K] "
                         "accumulator slots must fit shared memory)")
    if S > 65535:
        raise ValueError(f"{ESTEP_NAME} takes at most 65535 restarts, got {S}")
    smem = _smem_bytes(K, R, tile, wb1)
    streams = torch.empty((2, B, S * K), dtype=torch.float32, device=dev)
    theta_hat = torch.zeros_like(thetas)
    if B == 0:
        return streams, theta_hat, torch.zeros_like(ps), torch.zeros(
            S, dtype=torch.float32, device=dev)
    piece_rows, pieces = bdg_pieces(B, S, tile, em_bdr.sm_count(dev))
    part_th, part_p = bdg_buffers(pieces, S, K, R, wb1, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tip_em_bdg(
            thetas.data_ptr(), ps.data_ptr(), batch.triplets.data_ptr(),
            batch.ratings.data_ptr(), batch.weights.data_ptr(),
            batch.g1_lid.data_ptr(), batch.g1_offsets.data_ptr(), streams.data_ptr(),
            theta_hat.data_ptr(), part_th.data_ptr(), part_p.data_ptr(),
            S, B, G, K, R, Q1, wb1, tile, piece_rows, em_bdr.THREADS, smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, ESTEP_NAME)
    bdg_estep.launches += 1
    cells = ps[0].numel()
    p_hat, ll = block_sum.block_sum([block_sum.Segment(part_p, 0, cells),
                                     block_sum.Segment(part_p, cells, 1)])
    return streams, theta_hat, p_hat.view(ps.shape), ll.view(S)


bdg_estep.launches = 0
bdg_estep.kernel_name = ESTEP_NAME


def bdg_em_ensemble_stats(thetas, ps, batch: Batch, wb1: int = DEFAULT_WB1,
                          wb: int = em_bd.DEFAULT_WB) -> SweepStats:
    """One whole-ensemble sweep over g1-ordered rows (any G): the E-step
    with position 1 fused, then the 2-position plan scatter into the same
    theta_hat."""
    require_g1_plan(batch)
    S, G, K = thetas.shape
    streams, theta_hat, p_hat, ll = bdg_estep(thetas, ps, batch, wb1)
    em_bd.plan_scatter(streams, batch.scatter_perm, batch.scatter_lid,
                       batch.scatter_offsets, wb, G, K, out=theta_hat)
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=ll)


def bdg_em_ensemble_stats_reference(thetas, ps, batch: Batch, wb1: int = DEFAULT_WB1,
                                    wb: int = em_bd.DEFAULT_WB) -> SweepStats:
    """:func:`bdg_em_ensemble_stats` through both plain versions, on any
    device."""
    require_g1_plan(batch)
    S, G, K = thetas.shape
    streams, theta_hat, p_hat, ll = bdg_estep_reference(thetas, ps, batch, wb1)
    em_bd.plan_scatter_reference(streams, batch.scatter_perm, batch.scatter_lid,
                                 batch.scatter_offsets, wb, G, K, out=theta_hat)
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=ll)
