"""Split-merge proposal moves for EM refinement (``TrainConfig.smem_rounds``).

The port's copy of the reference's ``models/proposals.py`` (plain NumPy,
the same arrays and moves for the same ``numpy.random.Generator``).

Split-merge EM (after Ueda et al. 2000, adapted to the tensorial MMSBM)
makes *structured* jumps between likelihood basins of different group
topology: merge the two most redundant groups, split a heavy group in two,
resweep, and keep the move only if the full train likelihood improves.
Plain restarts resample the same shallow basins and Dirichlet perturbation
(``refine_rounds``) only explores the current basin's neighborhood; a
merge-split changes which groups exist, the failure mode neither can fix
(one starved component, another doing double duty).

Proposals are host-side numpy on [G, K] / [K,..,K,R] arrays (KB-scale);
the resweeps ride the lane-stacked restart ensemble on the device.
"""

from __future__ import annotations

import numpy as np


def merge_split_candidate(
    theta: np.ndarray,
    p: np.ndarray,
    rng: np.random.Generator,
    jitter: float = 0.05,
    top_pairs: int = 5,
):
    """One split-merge proposal applied to a single restart's (theta, p).

    Merge: sampled from the ``top_pairs`` most-parallel theta-column pairs
    (cosine similarity — parallel columns are redundant groups).  Split: a
    mass-weighted draw over the surviving groups, carved per-gene by a
    Beta(2,2) fraction so every theta row stays on the simplex.  p slices
    follow the same index map on every membership axis (mass-weighted
    average for the merge, jittered copies for the split children — the
    next M-step re-estimates p from theta anyway, theta carries the
    proposal).  K and all shapes are preserved; works for both the trigenic
    (p[K,K,K,R]) and digenic (p[K,K,R]) families.

    Returns ``(theta', p', (j, k, split))`` with float32 arrays.
    """
    theta = np.asarray(theta, np.float64)
    p = np.asarray(p, np.float64)
    G, K = theta.shape
    if K < 3:
        raise ValueError(f"split-merge needs K >= 3, got K={K}")
    arity = p.ndim - 1
    mass = theta.sum(0)  # [K]
    cols = theta / np.maximum(np.linalg.norm(theta, axis=0, keepdims=True), 1e-12)
    sim = cols.T @ cols
    iu = np.triu_indices(K, 1)
    pair_order = np.argsort(-sim[iu])[: max(top_pairs, 1)]
    pick = pair_order[rng.integers(len(pair_order))]
    j, k = int(iu[0][pick]), int(iu[1][pick])
    w = mass.copy()
    w[[j, k]] = 0.0
    if w.sum() < 1e-12:
        # All theta mass sits in the merge pair (starved remaining groups —
        # exactly the states split-merge targets): fall back to a uniform
        # draw over the K-2 survivors instead of a zero probability vector.
        w = np.ones(K)
        w[[j, k]] = 0.0
    split = int(rng.choice(K, p=w / w.sum()))

    # theta [G, K] -> [G, K]: the merge loses one column, the split adds one.
    keep = [g for g in range(K) if g not in (j, k, split)]
    merged = theta[:, j] + theta[:, k]
    u = rng.beta(2.0, 2.0, size=G)  # per-gene carve keeps rows on the simplex
    new_theta = np.stack(
        [merged, theta[:, split] * u, theta[:, split] * (1.0 - u)]
        + [theta[:, g] for g in keep],
        axis=1,
    )

    # p: one old->new map M applied on every membership axis, mass-weighted.
    wj = mass[j] / max(mass[j] + mass[k], 1e-12)
    M = np.zeros((K, K), np.float64)
    M[j, 0] = wj
    M[k, 0] = 1.0 - wj
    M[split, 1] = 1.0
    M[split, 2] = 1.0
    for i, g in enumerate(keep):
        M[g, 3 + i] = 1.0
    q = p
    for ax in range(arity):
        q = np.moveaxis(np.tensordot(q, M, axes=([ax], [0])), -1, ax)
    q *= 1.0 + jitter * rng.standard_normal(q.shape)
    q = np.clip(q, 1e-8, None)
    q /= q.sum(-1, keepdims=True)
    return new_theta.astype(np.float32), q.astype(np.float32), (j, k, split)
