"""Held-out triplet scoring (counterpart of the reference's
``ops/scoring.py``).

P(r | genes) is the E-step denominator evaluated for every rating:
score[b, r] = sum_klm theta1[b,k] theta2[b,l] theta3[b,m] p[k,l,m,r]
(one K axis fewer for the digenic family).  Every function takes one
state or a restart-stacked ensemble (leading [S] axis).
"""

from __future__ import annotations

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu_torch.ops.em import _gather
from trigenicinteractionpredictor_tpu_torch.utils.tracing import span


def predict_proba(state: ModelState, triplets: torch.Tensor) -> torch.Tensor:
    """P(r | genes) for every row: f32 [..., B, R]."""
    theta, p = state.theta, state.p
    K = theta.shape[-1]
    R = p.shape[-1]
    lead = theta.shape[:-2]
    B = triplets.shape[0]
    if triplets.shape[1] == 2:
        th1, th2 = _gather(theta, triplets)
        A2 = torch.matmul(th1, p.reshape(lead + (K, K * R)))
        return torch.einsum("...blr,...bl->...br", A2.reshape(lead + (B, K, R)), th2)
    th1, th2, th3 = _gather(theta, triplets)
    W = (th1.unsqueeze(-1) * th2.unsqueeze(-2)).reshape(lead + (B, K * K))
    A3 = torch.matmul(W, p.reshape(lead + (K * K, K * R)))
    return torch.einsum("...bmr,...bm->...br", A3.reshape(lead + (B, K, R)), th3)


def predict_interaction(
    state: ModelState, triplets: torch.Tensor, interact_rating: int = 1
) -> torch.Tensor:
    """P(r = interact | genes): the ranking score.  f32 [..., B]."""
    return predict_proba(state, triplets)[..., interact_rating]


def ensemble_predict_interaction(
    states: ModelState, triplets: torch.Tensor, interact_rating: int = 1
) -> torch.Tensor:
    """P(interact) averaged over the restart axis (the reference's
    sample-averaging protocol).  f32 [B]."""
    return predict_interaction(states, triplets, interact_rating).mean(0)


def serve_route(device_type: str, ensemble: bool, arity: int, k: int,
                fast: bool = True) -> str:
    """The scorer :func:`serve_predict_interaction` runs: the K2 kernel's
    name for restart-stacked trigenic states on CUDA with ``fast`` at a K
    inside K2's plan (K <= 136), else ``"torch"`` (the plain scorer).  A
    shape rule decided before any launch, as the reference's
    ``_fit_score_tile`` rule; never a fallback after a failed launch."""
    from trigenicinteractionpredictor_tpu_torch.ops import score

    if (fast and ensemble and arity == 3 and device_type == "cuda"
            and score.score_plan(k) is not None):
        return score.KERNEL_NAME
    return "torch"


def _checked_ids(trips: np.ndarray, n_genes: int) -> torch.Tensor:
    """The ids as a CPU tensor, after one threaded pass (``torch.aminmax``)
    over them in their own dtype has found each in [0, ``n_genes``), so
    int64 ids past int32 are caught before any narrowing; else
    ``ValueError``.  The tensor views ``trips``; a copy is made only where
    torch cannot view or reduce the array (negative strides, a foreign
    byte order, unsigned ids wider than a byte)."""
    if trips.dtype.kind == "u" and trips.dtype.itemsize > 1:
        trips = trips.astype(np.int64)
    elif not trips.dtype.isnative or any(st < 0 for st in trips.strides):
        trips = np.ascontiguousarray(trips, trips.dtype.newbyteorder("="))
    ids = torch.from_numpy(trips)
    lo, hi = torch.aminmax(ids)
    if lo < 0 or hi >= n_genes:
        raise ValueError(f"gene ids must lie in [0, {n_genes})")
    return ids


def serve_predict_interaction(
    states: ModelState,
    triplets,
    interact_rating: int = 1,
    block_rows: int = 131072,
    fast: bool = True,
) -> np.ndarray:
    """Score many rows (numpy in, numpy out) on the states' device.

    The ids are checked on the host before any device work: one out of
    range raises ``ValueError`` and nothing is scored.  The scorer is
    :func:`serve_route`'s: the K2 kernel (ops/score.py) for restart-stacked
    trigenic states on CUDA with ``fast``; the plain scorer for
    ``fast=False``, single states, the digenic family, the CPU and K past
    K2's plan.  Rows go in blocks of ``block_rows``, one scorer call a
    block; on CUDA they are fed by :func:`_pinned_feed`, on the CPU the
    scorer reads them in place.  The kernel is exact float32, so both
    scorers agree to rounding.  The caller owns the returned array.  Under
    ``torch.profiler`` a call records the spans ``serve``,
    ``serve.check_ids``, ``serve.copy_in`` per block (on CUDA per chunk of
    blocks), ``serve.score`` per block and ``serve.copy_out``
    (``utils/tracing.py``).
    """
    with span("serve"):
        with span("serve.check_ids"):
            trips = np.asarray(triplets)
            n = trips.shape[0]
            if n == 0:
                return np.zeros((0,), np.float32)
            ids = _checked_ids(trips, states.n_genes)
        device = states.device
        ensemble = states.theta.dim() == 3
        if serve_route(device.type, ensemble, ids.shape[1], states.k, fast) != "torch":
            from trigenicinteractionpredictor_tpu_torch.ops.score import ensemble_score

            thetas, ps = states.theta.contiguous(), states.p.contiguous()

            def score(tr):
                return ensemble_score(thetas, ps, tr, interact_rating)
        elif ensemble:
            def score(tr):
                return ensemble_predict_interaction(states, tr, interact_rating)
        else:
            def score(tr):
                return predict_interaction(states, tr, interact_rating)
        block = max(1, min(block_rows, n))
        if device.type == "cuda":
            return _pinned_feed(ids, score, block, device)
        out = torch.empty(n, dtype=torch.float32, device=device)
        for i in range(0, n, block):
            with span("serve.copy_in"):
                tr = ids[i : i + block].to(device, torch.int32)
            with span("serve.score"):
                out[i : i + block] = score(tr)
        with span("serve.copy_out"):
            return out.cpu().numpy()


serve_predict_interaction.staged_blocks = 0


# The CUDA feed stages and sends rows in chunks of at most this many blocks.
FEED_CHUNK_BLOCKS = 4


def _feed_chunks(n: int, block: int):
    """The row ranges [a, b) the CUDA feed stages and sends at once: one
    block, then chunks as long as all rows before them, up to
    ``FEED_CHUNK_BLOCKS`` blocks; every bound but ``n`` a whole number of
    blocks.  So the first scorer call waits for one block only, and a call
    makes a few threaded copies rather than one a block: each such copy can
    stall on a descheduled thread."""
    a = 0
    while a < n:
        b = min(n, a + max(block, min(a, FEED_CHUNK_BLOCKS * block)))
        yield a, b
        a = b


def _pinned_feed(ids: torch.Tensor, score, block: int, device: torch.device) -> np.ndarray:
    """The CUDA feed of :func:`serve_predict_interaction`: each chunk of
    blocks (:func:`_feed_chunks`) is narrowed to int32 into pinned host
    memory by a threaded ``copy_`` and sent with ``non_blocking`` on a side
    stream; the scoring stream waits for that chunk only, so the next
    chunk's copy overlaps this chunk's scorer calls, one a block.  The
    scores come back through pinned memory with the call's one blocking
    sync, then by one threaded copy into a fresh array: a pinned array
    handed to a caller that keeps it would have the next call pin new memory
    (``cudaHostAlloc``, milliseconds).  Pinned memory comes from torch's
    caching host allocator, per call, so two threads may call at once.
    Counts the blocks it fed in ``serve_predict_interaction.staged_blocks``."""
    n = ids.shape[0]
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    staged = torch.empty(ids.shape, dtype=torch.int32, pin_memory=True)
    rows = torch.empty(ids.shape, dtype=torch.int32, device=device)
    out = torch.empty(n, dtype=torch.float32, device=device)
    side.wait_stream(cur)  # rows may reuse memory that work queued on cur still reads
    for a, b in _feed_chunks(n, block):
        with span("serve.copy_in"):
            staged[a:b].copy_(ids[a:b])
            with torch.cuda.stream(side):
                rows[a:b].copy_(staged[a:b], non_blocking=True)
            cur.wait_stream(side)
        for i in range(a, b, block):
            with span("serve.score"):
                out[i : i + block] = score(rows[i : i + block])
    serve_predict_interaction.staged_blocks += -(-n // block)
    with span("serve.copy_out"):
        host = torch.empty(n, dtype=torch.float32, pin_memory=True)
        host.copy_(out, non_blocking=True)
        cur.synchronize()
        scores = np.empty(n, np.float32)
        torch.from_numpy(scores).copy_(host)
        return scores
