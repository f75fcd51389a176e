"""Ranking metrics: ROC-AUC and average precision (counterpart of the
reference's ``ops/metrics.py``).

Both handle ties (average ranks for AUC; sort order for AP, as the
reference) and per-row weights: weight-0 rows (padding) are pushed to the
bottom of the ranking and out of every count.  Statistics accumulate in
float64; each function returns a 0-d float64 tensor.
"""

from __future__ import annotations

from typing import Optional

import torch


def _average_ranks(scores: torch.Tensor) -> torch.Tensor:
    """1-based ranks with ties sharing their average rank.  O(B log B)."""
    B = scores.shape[0]
    order = torch.argsort(scores, stable=True)
    sorted_scores = scores[order]
    is_new = torch.ones(B, dtype=torch.bool, device=scores.device)
    is_new[1:] = sorted_scores[1:] != sorted_scores[:-1]
    group = torch.cumsum(is_new.long(), 0) - 1
    ranks_sorted = torch.arange(1, B + 1, dtype=torch.float64, device=scores.device)
    n_groups = int(group[-1]) + 1 if B else 0
    g_sum = torch.zeros(n_groups, dtype=torch.float64, device=scores.device)
    g_cnt = torch.zeros_like(g_sum)
    g_sum.index_add_(0, group, ranks_sorted)
    g_cnt.index_add_(0, group, torch.ones_like(ranks_sorted))
    ranks = torch.empty_like(ranks_sorted)
    ranks[order] = (g_sum / g_cnt)[group]
    return ranks


def _prep(scores, labels, weights):
    scores = torch.as_tensor(scores).to(torch.float32)
    y = torch.as_tensor(labels, device=scores.device).to(torch.float64)
    if weights is None:
        w = torch.ones_like(y)
    else:
        w = torch.as_tensor(weights, device=scores.device).to(torch.float64)
    eff = torch.where(w > 0, scores, torch.full_like(scores, float("-inf")))
    return eff, y, w


def auc(scores, labels, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ROC-AUC via the Mann-Whitney rank statistic, with tie correction;
    0.5 when either class is empty."""
    eff, y, w = _prep(scores, labels, weights)
    ranks = _average_ranks(eff)
    pos = y * w
    n_pos = pos.sum()
    n_neg = ((1.0 - y) * w).sum()
    # Padded rows hold the lowest ranks (all tied at -inf); shift real
    # ranks down so the statistic is over real rows only.
    n_pad = (w <= 0).sum().to(torch.float64)
    u = (pos * (ranks - n_pad)).sum() - n_pos * (n_pos + 1.0) / 2.0
    denom = n_pos * n_neg
    if float(denom) <= 0:
        return torch.tensor(0.5, dtype=torch.float64)
    return u / denom


def average_precision(
    scores, labels, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """AP = sum_i P@i * 1[label_i = 1] / n_pos over rows sorted by
    descending score (stable: ties keep row order); 0 with no positives."""
    eff, y, w = _prep(scores, labels, weights)
    order = torch.argsort(-eff, stable=True)
    y_sorted = (y * w)[order]
    seen = torch.cumsum(w[order], 0)
    precision_at = torch.cumsum(y_sorted, 0) / torch.clamp(seen, min=1.0)
    n_pos = (y * w).sum()
    if float(n_pos) <= 0:
        return torch.tensor(0.0, dtype=torch.float64)
    return (precision_at * y_sorted).sum() / n_pos
