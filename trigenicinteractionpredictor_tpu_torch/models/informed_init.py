"""Informed initialization from pairwise co-interaction marginals
(``TrainConfig.init_method = "spectral"``).

The port's copy of the reference's ``models/informed_init.py`` (plain
NumPy, bit-equal arrays for the same dataset and seed).

Random init relies on many restarts to escape bad EM basins; on peaky
ground truth every such chain can land in the same shallow basin.  This
module seeds theta from the data instead, using a method-of-moments
observation: under the MMSBM, the expected *pairwise* positive-interaction
count between genes g and h is a quadratic form in (theta[g], theta[h])
through the p tensor's pair marginal, so the centered co-occurrence matrix
of positive labels carries the group structure in its leading eigenspace.

Recipe (all host-side NumPy):

1. A[g, h]     = sum of weights of observations containing both g and h
   Apos[g, h]  = the same restricted to positive-label observations
2. M = Apos - rate * A, rate = total positive weight / total weight
   (the centering removes the degree-driven rank-1 background)
3. Top-K eigenvectors of symmetric M, scaled by sqrt(|eigenvalue|), give a
   spectral embedding X[G, K].
4. A few Lloyd iterations of k-means on X give K centers; theta0[g] is the
   softmax of negative scaled distances to the centers (soft assignment).
5. Each restart mixes theta0 with Dirichlet noise at increasing strength --
   restart 0 stays closest to the spectral solution, later restarts recover
   the diversity of random init.

p is initialized from the empirical rating distribution with per-restart
Dirichlet noise.

A and Apos are dense G x G float64 matrices (16 G^2 bytes together), so
the trainer refuses the spectral init above :data:`MAX_GENES`, where they
would pass 8 GiB.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset

# The largest G whose two G x G float64 co-occurrence matrices fit in 8 GiB.
MAX_GENES = 23_170


def _cooccurrence(
    ds: TripletDataset, interact_rating: int
) -> Tuple[np.ndarray, np.ndarray, float]:
    G = ds.n_genes
    arity = ds.arity
    A = np.zeros((G, G), dtype=np.float64)
    Apos = np.zeros((G, G), dtype=np.float64)
    w = ds.weights.astype(np.float64)
    pos = (ds.ratings == interact_rating).astype(np.float64) * w
    for i in range(arity):
        for j in range(arity):
            if i == j:
                continue
            gi = ds.triplets[:, i]
            gj = ds.triplets[:, j]
            np.add.at(A, (gi, gj), w)
            np.add.at(Apos, (gi, gj), pos)
    tot = float(w.sum())
    rate = float(pos.sum()) / max(tot, 1e-12)
    return A, Apos, rate


def spectral_embedding(
    ds: TripletDataset, k: int, interact_rating: int = 1
) -> np.ndarray:
    """X[G, K]: leading eigenspace of the centered positive co-occurrence."""
    A, Apos, rate = _cooccurrence(ds, interact_rating)
    M = Apos - rate * A
    M = 0.5 * (M + M.T)
    vals, vecs = np.linalg.eigh(M)
    order = np.argsort(-np.abs(vals))[:k]
    X = vecs[:, order] * np.sqrt(np.abs(vals[order]))[None, :]
    return X


def _kmeans(X: np.ndarray, k: int, seed: int, iters: int = 20) -> np.ndarray:
    """Plain Lloyd iterations; returns centers [k, d].  k-means++ seeding."""
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    centers = [X[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            ((X[:, None, :] - np.asarray(centers)[None]) ** 2).sum(-1), axis=1
        )
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(X[rng.choice(n, p=probs)])
    C = np.asarray(centers)
    for _ in range(iters):
        d2 = ((X[:, None, :] - C[None]) ** 2).sum(-1)
        assign = d2.argmin(axis=1)
        for c in range(k):
            mask = assign == c
            if mask.any():
                C[c] = X[mask].mean(axis=0)
    return C


def spectral_init_arrays(
    ds: TripletDataset,
    k: int,
    n_samples: int,
    seed: int = 0,
    eps_min: float = 0.05,
    eps_max: float = 0.75,
    interact_rating: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Restart-stacked (theta0[S, G, K], p0[S, K,..,K, R]) informed init.

    Restart s mixes the spectral soft assignment with Dirichlet(1) noise at
    strength eps_s, linearly spaced over [eps_min, eps_max] — a bridge from
    "trust the spectrum" to "explore like random init".
    """
    G, R, arity = ds.n_genes, ds.n_ratings, ds.arity
    rng = np.random.default_rng(seed + 0x5EC)
    X = spectral_embedding(ds, k, interact_rating)
    C = _kmeans(X, k, seed)
    d2 = ((X[:, None, :] - C[None]) ** 2).sum(-1)                  # [G, K]
    # Soft assignment: temperature from the median distance scale.
    tau = max(np.median(d2), 1e-9)
    logits = -d2 / tau
    logits -= logits.max(axis=1, keepdims=True)
    theta0 = np.exp(logits)
    theta0 /= theta0.sum(axis=1, keepdims=True)                    # [G, K]

    # Empirical rating distribution for p0.
    w = ds.weights.astype(np.float64)
    freq = np.zeros(R)
    for r in range(R):
        freq[r] = float(w[ds.ratings == r].sum())
    freq = np.maximum(freq / max(freq.sum(), 1e-12), 1e-3)
    freq /= freq.sum()

    S = n_samples
    eps = np.linspace(eps_min, eps_max, S) if S > 1 else np.asarray([eps_min])
    thetas = np.empty((S, G, k), dtype=np.float32)
    ps = np.empty((S,) + (k,) * arity + (R,), dtype=np.float32)
    for s in range(S):
        noise_t = rng.dirichlet(np.ones(k), size=G)
        th = (1.0 - eps[s]) * theta0 + eps[s] * noise_t
        thetas[s] = (th / th.sum(axis=1, keepdims=True)).astype(np.float32)
        noise_p = rng.dirichlet(np.ones(R), size=(k,) * arity)
        pp = (1.0 - eps[s]) * freq[(None,) * arity] + eps[s] * noise_p
        ps[s] = (pp / pp.sum(axis=-1, keepdims=True)).astype(np.float32)
    return thetas, ps
