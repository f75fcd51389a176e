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


def serve_predict_interaction(
    states: ModelState,
    triplets,
    interact_rating: int = 1,
    block_rows: int = 131072,
    fast: bool = True,
) -> np.ndarray:
    """Score many rows (numpy in, numpy out) on the states' device.

    The scorer is :func:`serve_route`'s: the K2 kernel (ops/score.py) for
    restart-stacked trigenic states on CUDA with ``fast``; the plain scorer
    for ``fast=False``, single states, the digenic family, the CPU and K
    past K2's plan.  Rows go in blocks of ``block_rows``; results stay on
    the device until one copy at the end.  The kernel is exact float32, so
    both paths agree to rounding.
    """
    trips = np.asarray(triplets)
    n = trips.shape[0]
    if n == 0:
        return np.zeros((0,), np.float32)
    G = states.n_genes
    if trips.min() < 0 or trips.max() >= G:
        raise ValueError(f"gene ids must lie in [0, {G})")
    device = states.device
    ensemble = states.theta.dim() == 3
    use_kernel = (
        serve_route(device.type, ensemble, trips.shape[1], states.k, fast) != "torch"
    )
    if use_kernel:
        from trigenicinteractionpredictor_tpu_torch.ops.score import ensemble_score

        thetas, ps = states.theta.contiguous(), states.p.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=device)
    block = max(1, min(block_rows, n))
    for i in range(0, n, block):
        tr = torch.as_tensor(trips[i : i + block], dtype=torch.int32, device=device)
        if use_kernel:
            out[i : i + block] = ensemble_score(thetas, ps, tr, interact_rating)
        elif ensemble:
            out[i : i + block] = ensemble_predict_interaction(states, tr, interact_rating)
        else:
            out[i : i + block] = predict_interaction(states, tr, interact_rating)
    return out.cpu().numpy()
