"""K4: the bdg sweep of the large-G routes (counterpart of the reference's
``ops/pallas_em_bdg.py``: ``G1Plan``, ``make_g1_plan``,
``apply_g1_order``, ``_bdg_estep`` and ``bdg_em_ensemble_stats``).

Rows go in the order of a g1 plan (stably sorted by the gene block of
position 1), so :func:`bdg_estep` (``csrc/em_bdg.cu``) reads position 1's
theta rows, and sums its theta_hat share, one gene block at a time in
shared memory.  Positions 2 and 3 leave the E-step as streams [2, B, S*K]
and reach theta_hat through ``ops/em_bd.py::plan_scatter`` with a
2-position scatter plan built on the reordered rows.

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
    position_marginals,
    segment_rows,
)
from trigenicinteractionpredictor_tpu_torch.ops.em_large_g import _check_ids

KERNEL_NAME = "cuda-em-bdg"
ESTEP_NAME = "cuda-em-bdg-estep"
WB1_CHOICES = (512, 256, 128, 64, 32)  # gene-block widths, widest first
DEFAULT_WB1 = WB1_CHOICES[0]
_SM_SMEM = 233_472       # shared memory of one H100 SM, bytes
_BLOCK_RESERVED = 1024   # of it, reserved per resident block
_MAX_RESIDENT = 3        # blocks per SM: the kernel's __launch_bounds__(256, 3)
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


def _smem_bytes(k: int, n_ratings: int, tile: int, wb1: int) -> int:
    """K1's tile buffers plus the theta block and its accumulator, [wb1, K]
    each."""
    return em_bdr.tile_smem_bytes(k, n_ratings, tile) + 8 * wb1 * k


def _tile(k: int, n_ratings: int, wb1: int) -> Optional[int]:
    """The largest row tile whose buffers fit one block's shared memory."""
    for tile in em_bdr.TILES:
        if _smem_bytes(k, n_ratings, tile, wb1) <= em_bdr.SMEM_LIMIT:
            return tile
    return None


def _resident(smem: int) -> int:
    """Blocks of the kernel one SM holds at ``smem`` bytes each."""
    return min(_MAX_RESIDENT, _SM_SMEM // (smem + _BLOCK_RESERVED))


def bdg_plan(k: int, n_ratings: int) -> Optional[Tuple[int, int]]:
    """(row tile, wb1) of the kernel at this (K, R): the largest tile that
    fits, then the widest gene block that costs no resident block per SM
    against the tile buffers alone (else the widest that fits); None
    outside K1's range.  Measured on the H100 at K = 10, R = 2 (PERF.md):
    a block width that keeps three blocks per SM (then 128) ran 5-22%
    faster than 512; with the register-tiled algebra's buffers it is 64."""
    if em_bdr.sweep_plan(k, n_ratings) is None:
        return None
    for tile in em_bdr.TILES:
        base = _smem_bytes(k, n_ratings, tile, 0)
        if base > em_bdr.SMEM_LIMIT:
            continue
        fits = [w for w in WB1_CHOICES
                if _smem_bytes(k, n_ratings, tile, w) <= em_bdr.SMEM_LIMIT]
        keep = [w for w in fits
                if _resident(_smem_bytes(k, n_ratings, tile, w)) >= _resident(base)]
        if keep or fits:
            return tile, (keep or fits)[0]
    return None


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


def bdg_estep_reference(thetas, ps, batch: Batch, wb1: int = DEFAULT_WB1):
    """The plain version of :func:`bdg_estep`."""
    S, G, K = thetas.shape
    gene1 = em_bd._plan_genes(batch.g1_lid, batch.g1_offsets, wb1)
    trip = torch.stack([gene1.to(batch.triplets.dtype), batch.triplets[:, 1],
                        batch.triplets[:, 2]], dim=1)
    vals, p_hat, loglik = position_marginals(thetas, ps, batch._replace(triplets=trip))
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
                         "blocks must fit shared memory)")
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


bdg_em_ensemble_stats.kernel_name = KERNEL_NAME


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
