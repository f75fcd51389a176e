"""Seeds from the triplet tensor's own structure for the peaky config
(counterpart of the reference's ``tools/tensor_spectral_study.py``).

On peaky ground truth (alpha_theta = 0.05) a seed of high enough partition
purity lets EM reach the deep basin, and pairwise seeds (the spectral
init) do not get there.  This study measures two seeds built from the
TRIGENIC joint structure:

1. ``unfold`` -- tensor-unfolding spectral init: the mode-1 unfolding
   M[i, (j, e)] of the centered rating tensor (each gene's profile over the
   pairs it was observed with), the top-K eigenvectors of its row-normalized
   [G, G] gram, k-means, purity against the true partition;
2. ``agree`` -- aligned-ensemble agreement: fit a wide short ensemble,
   greedily align every restart's theta columns to the best lane's by
   correlation, average the aligned thetas, take argmax labels.

For a method with purity > 0.3 it also seeds a full EM from the partition
and reports its train L and held-out AUC.  One JSON line per method.

Usage:
    python -m trigenicinteractionpredictor_tpu_torch.tools.tensor_spectral_study --device cpu [--seeds 3]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.config import Config, TrainConfig
from trigenicinteractionpredictor_tpu_torch.data.splits import train_test_split
from trigenicinteractionpredictor_tpu_torch.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu_torch.models.informed_init import _kmeans
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState, init_state, to_numpy
from trigenicinteractionpredictor_tpu_torch.ops.metrics import auc
from trigenicinteractionpredictor_tpu_torch.ops.scoring import ensemble_predict_interaction
from trigenicinteractionpredictor_tpu_torch.tools.quality_study import study_device, study_parser
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit


def purity(labels: np.ndarray, truth: np.ndarray, k: int) -> float:
    """Cluster purity: the fraction of genes whose predicted cluster's
    majority true label matches theirs."""
    total = 0
    for c in range(k):
        members = truth[labels == c]
        if members.size:
            total += np.bincount(members).max()
    return total / labels.shape[0]


def unfold_labels(ds, g: int, k: int, seed: int) -> np.ndarray:
    """Mode-1 unfolding spectral partition."""
    trip = np.asarray(ds.triplets)
    rat = np.asarray(ds.ratings).astype(np.float64)
    real = np.asarray(ds.weights) > 0
    trip, rat = trip[real], rat[real]
    centered = rat - rat.mean()

    M = np.zeros((g, g * g), np.float64)   # dense mode-1 unfolding
    C = np.zeros((g, g * g), np.float64)   # observation counts
    for pos in range(3):
        i = trip[:, pos]
        o1 = trip[:, (pos + 1) % 3]
        o2 = trip[:, (pos + 2) % 3]
        pid = np.minimum(o1, o2) * g + np.maximum(o1, o2)
        np.add.at(M, (i, pid), centered)
        np.add.at(C, (i, pid), 1.0)
    np.divide(M, C, out=M, where=C > 0)   # mean centered rating per cell
    M *= np.sqrt(C)                       # frequent pairs carry more evidence
    # row-normalize so high-degree genes don't dominate the gram
    Mn = M / np.maximum(np.linalg.norm(M, axis=1, keepdims=True), 1e-12)
    gram = Mn @ Mn.T
    np.fill_diagonal(gram, 0.0)
    _, vecs = np.linalg.eigh(gram)
    X = vecs[:, -k:]
    X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    centers = _kmeans(X, k, seed)
    d2 = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
    return d2.argmin(axis=1)


def agree_labels(train, g: int, k: int, s: int, sweeps: int, seed: int, device="cpu"):
    """Aligned-ensemble agreement partition: greedily match every restart's
    theta columns to the best-likelihood lane's by correlation, average
    the aligned thetas, take argmax labels."""
    cfg = Config(train=TrainConfig(k=k, sweeps=sweeps, samples=s, likelihood_freq=sweeps,
                                   seed=seed))
    res = fit(cfg, train, device=device)
    thetas = to_numpy(res.states.theta)              # [S, G, K]
    ref = thetas[int(np.argmax(np.asarray(res.final_loglik)))]
    acc = np.zeros_like(ref)
    for t in thetas:
        corr_w = ref.T @ t                             # [K, K] (ref col, t col)
        to_ref = np.full(k, -1)                        # t col -> ref col
        for _ in range(k):
            a, b = np.unravel_index(np.argmax(corr_w), corr_w.shape)
            to_ref[b] = a
            corr_w[a, :] = -np.inf
            corr_w[:, b] = -np.inf
        aligned = np.empty_like(t)
        aligned[:, to_ref] = t                         # t's columns at ref's slots
        acc += aligned
    return np.argmax(acc, axis=1)


def seeded_fit(train, test, labels, g, k, sweeps, s, seed, device="cpu"):
    """A fit of ``s`` lanes seeded from the partition (each lane jittered so
    restarts differ; p from the port's seeded draw): (best train L,
    held-out ensemble AUC)."""
    base = init_state(g, k, train.n_ratings, samples=s, seed=seed)
    theta_seed = np.full((g, k), 0.25 / (k - 1), np.float32)
    theta_seed[np.arange(g), labels] = 0.75
    rng = np.random.default_rng(seed)
    lanes = []
    for _ in range(s):
        jit = rng.dirichlet(np.ones(k) * 50, size=g).astype(np.float32)
        lane = 0.8 * theta_seed + 0.2 * jit
        lanes.append(lane / lane.sum(1, keepdims=True))
    init = ModelState(theta=np.stack(lanes), p=to_numpy(base.p))
    cfg = Config(train=TrainConfig(k=k, sweeps=sweeps, samples=s, likelihood_freq=100,
                                   seed=seed))
    res = fit(cfg, train, device=device, init_states=init)
    dev = res.states.device
    scores = ensemble_predict_interaction(
        res.states, torch.as_tensor(np.asarray(test.triplets), device=dev))
    labels_te = torch.as_tensor((np.asarray(test.ratings) == 1).astype(np.int32), device=dev)
    a = float(auc(scores, labels_te, torch.as_tensor(np.asarray(test.weights), device=dev)))
    return float(np.max(res.final_loglik)), a


def main(argv=None) -> int:
    ap = study_parser(__doc__.splitlines()[0])
    ap.add_argument("-n", type=int, default=20_000)
    ap.add_argument("-g", "--genes", type=int, default=200)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("--alpha-theta", type=float, default=0.05)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--sweeps", type=int, default=300)
    ap.add_argument("--methods", default="unfold,agree")
    args = ap.parse_args(argv)
    dev = study_device(args)

    N, G, K = args.n, args.genes, args.k
    ds, theta_star, _ = sample_synthetic_dataset(N, G, K, alpha_theta=args.alpha_theta,
                                                 alpha_p=0.3, seed=11)
    truth = np.argmax(theta_star, axis=1)
    train, test = train_test_split(ds, 0.2, 0)

    for method in args.methods.split(","):
        purities = []
        for s_i in range(args.seeds):
            if method == "unfold":
                labels = unfold_labels(train, G, K, seed=s_i)
            elif method == "agree":
                labels = agree_labels(train, G, K, s=16, sweeps=120, seed=s_i, device=dev)
            else:
                raise ValueError(method)
            purities.append(purity(labels, truth, K))
        best = int(np.argmax(purities))
        rec = {
            "method": method,
            "purity_mean": round(float(np.mean(purities)), 3),
            "purity_best": round(float(np.max(purities)), 3),
            "seeds": args.seeds,
        }
        if max(purities) > 0.3:
            if method == "unfold":
                labels = unfold_labels(train, G, K, seed=best)
            else:
                labels = agree_labels(train, G, K, 16, 120, best, device=dev)
            ll, a = seeded_fit(train, test, labels, G, K, args.sweeps, s=8, seed=0, device=dev)
            rec.update(seeded_train_ll=round(ll, 1), seeded_heldout_auc=round(a, 4))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
