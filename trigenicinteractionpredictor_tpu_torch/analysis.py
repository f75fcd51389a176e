"""Cross-restart analysis of a restart-stacked checkpoint (counterpart of
the reference's ``analysis.py``), in plain tensors and numpy:

- do independent restarts agree on the ranking?  Pairwise Pearson
  correlation of per-restart interaction scores on a probe set;
- did restarts find the same blocks?  theta columns compared after greedy
  alignment (groups are identifiable only up to permutation);
- which restart to trust?  Per-restart training likelihood and, with
  labels, held-out AUC.

The report's keys are the reference's.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState, to_numpy
from trigenicinteractionpredictor_tpu_torch.ops.metrics import auc
from trigenicinteractionpredictor_tpu_torch.ops.scoring import predict_interaction


def restart_score_agreement(
    states: ModelState, tuples: torch.Tensor, interact_rating: int = 1
) -> dict:
    """The S x S Pearson correlation of per-restart scores, and its mean and
    minimum off the diagonal (1.0 = every restart ranks alike).  A restart
    with constant scores has no defined correlation and counts as 0."""
    scores = to_numpy(predict_interaction(states, tuples, interact_rating)).astype(np.float64)
    S = scores.shape[0]
    corr = np.corrcoef(scores) if S > 1 else np.ones((1, 1))
    corr = np.nan_to_num(corr, nan=0.0)
    off = corr[~np.eye(S, dtype=bool)]
    return {
        "corr_matrix": corr.tolist(),
        "mean_pairwise_corr": float(off.mean()) if off.size else 1.0,
        "min_pairwise_corr": float(off.min()) if off.size else 1.0,
    }


def align_groups(theta_a: np.ndarray, theta_b: np.ndarray) -> dict:
    """Greedy-match B's groups onto A's by column cosine: the permutation of
    B's columns and the mean and minimum cosine of the matched pairs."""
    a = np.asarray(theta_a, dtype=np.float64)
    b = np.asarray(theta_b, dtype=np.float64)
    an = a / (np.linalg.norm(a, axis=0, keepdims=True) + 1e-12)
    bn = b / (np.linalg.norm(b, axis=0, keepdims=True) + 1e-12)
    remaining = an.T @ bn  # [K, K]
    K = remaining.shape[0]
    perm = np.full(K, -1, dtype=int)
    matched = []
    for _ in range(K):
        i, j = np.unravel_index(np.argmax(remaining), remaining.shape)
        perm[i] = j
        matched.append(float(remaining[i, j]))
        remaining[i, :] = -np.inf
        remaining[:, j] = -np.inf
    return {
        "permutation": perm.tolist(),
        "mean_matched_cosine": float(np.mean(matched)),
        "min_matched_cosine": float(np.min(matched)),
    }


def group_stability(states: ModelState) -> dict:
    """Every restart's groups aligned onto restart 0's, summarized."""
    theta = to_numpy(states.theta)
    if theta.ndim == 2:
        theta = theta[None]
    aligns = [align_groups(theta[0], theta[s]) for s in range(1, theta.shape[0])]
    cosines = [a["mean_matched_cosine"] for a in aligns] or [1.0]
    return {
        "vs_restart0": aligns,
        "mean_alignment": float(np.mean(cosines)),
        "min_alignment": float(np.min(cosines)),
    }


def analyze_checkpoint(
    checkpoint_path: str,
    tuples: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    interact_rating: int = 1,
    device="cpu",
) -> dict:
    """The cross-restart report of a checkpoint.  ``tuples`` (and raw rating
    ``labels``) add the score-agreement (and per-restart AUC) sections."""
    from trigenicinteractionpredictor_tpu_torch.train.checkpoint import load_checkpoint

    ck = load_checkpoint(checkpoint_path, device)
    states = ck["states"]
    if states.theta.dim() == 2:
        states = ModelState(theta=states.theta[None], p=states.p[None])
    S = states.theta.shape[0]
    ll_trace = np.asarray(ck["ll_trace"], dtype=np.float64)
    report: dict = {
        "checkpoint": os.path.abspath(checkpoint_path),
        "n_samples": int(S),
        "sweep": int(ck["sweep"]),
        "group_stability": group_stability(states),
    }
    if ll_trace.size:
        final = np.atleast_2d(ll_trace)[-1]
        report["final_loglik_per_sample"] = [float(x) for x in final]
        report["best_sample"] = int(np.argmax(final))
        report["loglik_spread"] = float(final.max() - final.min())
    if tuples is not None:
        trips = torch.as_tensor(np.asarray(tuples, dtype=np.int32), device=states.device)
        report["score_agreement"] = restart_score_agreement(states, trips, interact_rating)
        if labels is not None:
            y = torch.as_tensor(np.asarray(labels) == interact_rating, device=states.device)
            scores = predict_interaction(states, trips, interact_rating)
            per_auc = [float(auc(scores[s], y)) for s in range(S)]
            report["per_sample_auc"] = per_auc
            report["auc_spread"] = float(max(per_auc) - min(per_auc))
    return report


def write_analysis(report: dict, out_path: str) -> None:
    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=2)
