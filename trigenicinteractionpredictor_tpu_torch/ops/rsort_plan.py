"""The host plan of the rating-sorted sweep (the reference's
``ops/pallas_em_rsorted.py``: ``RatingSortPlan``, ``rating_sort_pad`` and
``apply_rating_sort``, bit for bit).

Rows are stably sorted by rating and each rating class is padded to whole
tiles of weight-0 rows, so every tile holds one rating, listed in the
int32 [n_tiles] tile table.  Row order is irrelevant to the sweep's
statistics (sums over rows) and weight-0 rows are inert.

NumPy only: ``train/stream_prep.py``'s spawn workers sort minibatches with
it and never import torch.  ``ops/em_rsorted.py`` re-exports it beside the
sweep.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

DEFAULT_TILE_B = 512


class RatingSortPlan(NamedTuple):
    """Host-side row order for rating-pure tiles (per data shard)."""

    order: np.ndarray      # int32 [n_shards * Bp] -- row permutation (padded)
    tile_r: np.ndarray     # int32 [n_shards * n_tiles] -- tile -> rating
    n_rows: int            # padded rows per shard (Bp)


def rating_sort_pad(
    ratings: np.ndarray,
    n_ratings: int,
    tile: int = DEFAULT_TILE_B,
    n_shards: int = 1,
    n_tiles: int = 0,
) -> RatingSortPlan:
    """Stable-sort rows by rating per shard; pad classes to tile multiples.

    ``order`` indexes into the shard, -1 marking a padding row (build the
    padded arrays with :func:`apply_rating_sort`).  Every rating class gets
    at least one tile, an empty one too; shards are padded to a common
    length with tiles that inherit the shard's last class.  ``n_tiles``
    (optional) forces a per-shard tile count, so many same-size row sets
    share one layout: the stepwise trainer passes the worst case
    ``B / tile + n_ratings``.
    """
    N = ratings.shape[0]
    assert N % n_shards == 0, (N, n_shards)
    B = N // n_shards
    per_shard = []
    for s in range(n_shards):
        r = ratings[s * B : (s + 1) * B]
        order = np.argsort(r, kind="stable").astype(np.int32)
        r_sorted = r[order]
        counts = np.bincount(r_sorted, minlength=n_ratings)
        o_parts, tiles = [], []
        start = 0
        for rr in range(n_ratings):
            c = int(counts[rr])
            t_q = max(1, -(-c // tile))
            pad = t_q * tile - c
            o_parts.append(order[start : start + c])
            if pad:
                o_parts.append(np.full(pad, -1, np.int32))  # inert padding
            tiles.extend([rr] * t_q)
            start += c
        per_shard.append((np.concatenate(o_parts), np.asarray(tiles, np.int32)))

    auto_tiles = max(len(t) for _, t in per_shard)
    if n_tiles:
        assert n_tiles >= auto_tiles, (
            f"forced n_tiles={n_tiles} < required {auto_tiles} "
            f"(B={B}, tile={tile}, n_ratings={n_ratings})"
        )
    n_tiles = n_tiles or auto_tiles
    Bp = n_tiles * tile
    order = np.full((n_shards, Bp), -1, np.int32)
    tile_r = np.zeros((n_shards, n_tiles), np.int32)
    for s, (o_, t_) in enumerate(per_shard):
        order[s, : len(o_)] = o_
        # common-length padding tiles inherit the last class (inert rows)
        pad_tiles = n_tiles - len(t_)
        if pad_tiles:
            t_ = np.concatenate([t_, np.full(pad_tiles, t_[-1], np.int32)])
        tile_r[s] = t_
    return RatingSortPlan(
        order=order.reshape(-1), tile_r=tile_r.reshape(-1), n_rows=Bp
    )


def apply_rating_sort(
    plan: RatingSortPlan,
    triplets: np.ndarray,
    ratings: np.ndarray,
    weights: np.ndarray,
    n_shards: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The sorted, padded row arrays.  A padding row repeats row 0 of its
    shard with weight 0, and its rating is its tile's class, so tiles stay
    rating-pure though the weight already makes the row inert."""
    N = ratings.shape[0]
    B = N // n_shards
    Bp = plan.n_rows
    n_tiles = plan.tile_r.shape[0] // n_shards
    tile = Bp // n_tiles
    out_t = np.empty((n_shards, Bp, triplets.shape[1]), triplets.dtype)
    out_r = np.empty((n_shards, Bp), ratings.dtype)
    out_w = np.zeros((n_shards, Bp), weights.dtype)
    order = plan.order.reshape(n_shards, Bp)
    tile_r = plan.tile_r.reshape(n_shards, n_tiles)
    for s in range(n_shards):
        pad = order[s] < 0
        idx = np.where(pad, 0, order[s])
        out_t[s] = triplets[s * B : (s + 1) * B][idx]
        out_r[s] = np.repeat(tile_r[s], tile)
        out_w[s] = np.where(pad, 0, weights[s * B : (s + 1) * B][idx])
    return (
        out_t.reshape(n_shards * Bp, -1),
        out_r.reshape(-1),
        out_w.reshape(-1),
    )
