"""K5a and K5b: the bd-plan sweep of the large-G routes (counterpart of the
reference's ``ops/pallas_em_bd.py``: ``_bd_estep``, ``_plan_scatter`` and
``bd_em_ensemble_stats``).

A sweep is two kernels:

- :func:`em_streams` (K5a, also K6's first stage: ``csrc/em_sweep.cu``,
  K1's kernel in its streams form, then ``ops/block_sum.py``) computes the
  E-step per row and restart and writes the three position-marginal
  streams [3, B, S*K] instead of a theta_hat, plus p_hat and loglik;
- :func:`plan_scatter` (``csrc/plan_scatter.cu``, K5b; also K6's second
  stage) segment-sums the streams into theta_hat [S, G, K] along the
  batch's scatter plan (``ops/em_large_g.py::make_scatter_plan``).

Each wrapper runs its plain version on a CPU tensor and launches its
kernel, or raises, on a CUDA tensor.  The plain scatter consumes the
plan's own slot order and gene ids (a segment sum in plan order), so a
wrong plan fails on the CPU too.  The reference's block-diagonal restart algebra
served only the TPU's matrix unit; the port computes each restart's stats
alone, in exact float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trigenicinteractionpredictor_tpu_torch.ops import _build, block_sum, em_bdr
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    Batch,
    SweepStats,
    position_marginals,
)

KERNEL_NAME = "cuda-em-bd-plan"
STREAMS_NAME = "cuda-em-streams"
SCATTER_NAME = "cuda-plan-scatter"
DEFAULT_WB = 512        # genes per plan block (the reference's _LARGE_G_WB)
COL_TILE = 128          # stream columns per scatter block (kColTile in the source)
_SCATTER_BLOCKS_PER_SM = 3  # kBlocksPerSm
_SCATTER_PIECE_FLOATS = 8192  # stream floats a block keeps in flight (one piece's rows)


class ScatterLaunch(NamedTuple):
    piece: int  # sorted slots per piece: the split limit of a gene's run
    vec: int    # floats per asynchronous copy (4, 2 or 1; divides S*K)
    smem: int   # dynamic shared memory, bytes


def scatter_plan(sk: int) -> ScatterLaunch:
    """The launch plan of :func:`plan_scatter` at stream width ``sk`` =
    S*K: the widest copy that keeps every row aligned; the piece, the
    power of two whose rows (a tile of at most COL_TILE columns wide) come
    to about 32 KB in flight a block, within 32..1024 slots (narrow streams
    take long pieces, so that a piece's fixed work is spread over as many
    bytes); and the bytes of the kernel's layout (two pieces of rows
    [piece, tile width], gene ids [piece + 2], three pieces of slot ids
    [piece] and local ids [piece + 2])."""
    width = min(sk, COL_TILE)
    vec = 4 if sk % 4 == 0 else 2 if sk % 2 == 0 else 1
    piece = max(32, min(1024, 1 << ((_SCATTER_PIECE_FLOATS // width).bit_length() - 1)))
    return ScatterLaunch(piece, vec, 4 * (2 * piece * width + 7 * piece + 8))


def require_plan(batch: Batch, what: str) -> None:
    if batch.scatter_perm is None or batch.scatter_offsets is None:
        raise ValueError(
            f"{what} needs a scatter plan on the batch; build one with "
            "ops.em_large_g.make_scatter_plan(...) and pass it to "
            "make_batch(..., scatter=plan)"
        )


def stack_streams(vals) -> torch.Tensor:
    """Per-position marginals, each [S, B, K], as streams [P, B, S*K]."""
    return torch.stack([v.movedim(0, 1).reshape(v.shape[1], -1) for v in vals])


def em_streams_reference(thetas, ps, batch: Batch):
    """The plain version of :func:`em_streams` (the ops/em.py algebra)."""
    vals, p_hat, loglik = position_marginals(thetas, ps, batch)
    return stack_streams(vals), p_hat, loglik


def em_streams(thetas, ps, batch: Batch):
    """(streams [3, B, S*K], p_hat [S,K,K,K,R], loglik [S]) of one sweep."""
    if thetas.device.type == "cpu":
        return em_streams_reference(thetas, ps, batch)
    plan = em_bdr.check_inputs(thetas, ps, batch, STREAMS_NAME)
    S, G, K = thetas.shape
    B = batch.triplets.shape[0]
    dev = thetas.device
    streams = torch.empty((3, B, S * K), dtype=torch.float32, device=dev)
    if B == 0:
        return streams, torch.zeros_like(ps), torch.zeros(S, dtype=torch.float32, device=dev)
    part = em_bdr.sweep_launch(thetas, ps, batch, STREAMS_NAME, streams=streams, plan=plan)
    em_streams.launches += 1
    cells = ps[0].numel()
    p_hat, ll = block_sum.block_sum([block_sum.Segment(part, 0, cells),
                                     block_sum.Segment(part, cells, 1)])
    return streams, p_hat.view(ps.shape), ll.view(S)


em_streams.launches = 0
em_streams.kernel_name = STREAMS_NAME


def _plan_genes(lid: torch.Tensor, offsets: torch.Tensor, wb: int) -> torch.Tensor:
    """Each slot's gene id: its CSR block * wb + its local id."""
    counts = offsets[1:].long() - offsets[:-1].long()
    block = torch.repeat_interleave(
        torch.arange(counts.numel(), device=lid.device), counts
    )
    return block * wb + lid.long()


def plan_scatter_reference(streams, perm, lid, offsets, wb: int, n_genes: int,
                           k: int, out=None) -> torch.Tensor:
    """The plain version of :func:`plan_scatter`: the permuted stream rows
    summed by the plan's gene ids, in plan order (a segment sum: the plan
    sorts the slots by gene)."""
    P, B, SK = streams.shape
    vals = streams.reshape(P * B, SK).index_select(0, perm.long())
    counts = torch.bincount(_plan_genes(lid, offsets, wb), minlength=n_genes)
    acc = torch.segment_reduce(vals, "sum", lengths=counts, axis=0)
    theta_hat = acc.reshape(n_genes, SK // k, k).movedim(1, 0)
    return theta_hat.contiguous() if out is None else out.add_(theta_hat)


def plan_scatter(streams, perm, lid, offsets, wb: int, n_genes: int, k: int,
                 out=None) -> torch.Tensor:
    """theta_hat [S, G, K] (+= into ``out`` when given) as the segment sum
    of the streams [P, B, S*K] along a scatter plan (slots ``perm`` in gene
    order, local ids ``lid``, CSR ``offsets`` per ``wb``-gene block)."""
    if streams.device.type == "cpu":
        return plan_scatter_reference(streams, perm, lid, offsets, wb, n_genes, k, out)
    P, B, SK = streams.shape
    S = SK // k
    L = perm.shape[0]
    Q = -(-n_genes // wb)
    dev = streams.device
    _build.require("streams", streams, torch.float32, (P, B, SK), dev)
    _build.require("scatter_perm", perm, torch.int32, (L,), dev)
    _build.require("scatter_lid", lid, torch.int32, (L,), dev)
    _build.require("scatter_offsets", offsets, torch.int32, (Q + 1,), dev)
    if L != P * B or SK != S * k:
        raise ValueError(f"{SCATTER_NAME}: a plan of {L} slots for {P} streams of "
                         f"{B} rows, width {SK} for K={k}")
    if out is None:
        out = torch.zeros((S, n_genes, k), dtype=torch.float32, device=dev)
    _build.require("theta_hat", out, torch.float32, (S, n_genes, k), dev)
    if L == 0:
        return out
    plan = scatter_plan(SK)
    n_pieces = -(-L // plan.piece)
    part = torch.empty((n_pieces, 2, SK), dtype=torch.float32, device=dev)
    edge = torch.empty((n_pieces, 2), dtype=torch.int32, device=dev)
    # Blocks that walk the pieces of each column tile: what the card holds.
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, _SCATTER_BLOCKS_PER_SM * n_sm // -(-SK // COL_TILE))
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tip_plan_scatter(
            streams.data_ptr(), perm.data_ptr(), lid.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), part.data_ptr(), edge.data_ptr(), L, Q, wb, SK, k, n_genes,
            plan.piece, plan.vec, blocks, plan.smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, SCATTER_NAME)
    plan_scatter.launches += 1
    return out


plan_scatter.launches = 0
plan_scatter.kernel_name = SCATTER_NAME


def bd_em_ensemble_stats(thetas, ps, batch: Batch, wb: int = DEFAULT_WB) -> SweepStats:
    """One whole-ensemble sweep through the streams and the plan scatter
    (any G).  ``batch`` carries a 3-position scatter plan of ``wb``-gene
    blocks for exactly its rows."""
    require_plan(batch, KERNEL_NAME)
    S, G, K = thetas.shape
    streams, p_hat, ll = em_streams(thetas, ps, batch)
    theta_hat = plan_scatter(streams, batch.scatter_perm, batch.scatter_lid,
                             batch.scatter_offsets, wb, G, K)
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=ll)


bd_em_ensemble_stats.kernel_name = KERNEL_NAME


def bd_em_ensemble_stats_reference(thetas, ps, batch: Batch,
                                   wb: int = DEFAULT_WB) -> SweepStats:
    """:func:`bd_em_ensemble_stats` through both plain versions, on any
    device (the card's comparisons and float64 runs)."""
    require_plan(batch, KERNEL_NAME)
    S, G, K = thetas.shape
    streams, p_hat, ll = em_streams_reference(thetas, ps, batch)
    theta_hat = plan_scatter_reference(streams, batch.scatter_perm, batch.scatter_lid,
                                       batch.scatter_offsets, wb, G, K)
    return SweepStats(theta_hat=theta_hat, p_hat=p_hat, loglik=ll)
