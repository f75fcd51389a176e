"""Synthetic trigenic data generated from a known (theta*, p*) (layer L1).

Serves three roles (SURVEY.md §5, BASELINE config 1):

1. the toy parity corpus (~1k triplets, K=2) checked against the NumPy
   oracle;
2. end-to-end convergence tests — the engine must recover held-out AUC near
   the Bayes rate of the generating model;
3. Kuzmin-scale benchmark inputs when the real Data S1 file is not present
   (the reference mount was empty; see SURVEY.md §0).

Also emits a Kuzmin-Data-S1-shaped TSV so the parser has a round-trip test.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset


def sample_ground_truth(
    n_genes: int,
    k: int,
    n_ratings: int = 2,
    alpha_theta: float = 0.5,
    alpha_p: float = 0.5,
    seed: int = 0,
    arity: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw (theta*[G,K], p*[K,...,K,R] with ``arity`` K axes) from
    Dirichlet priors."""
    rng = np.random.default_rng(seed)
    theta = rng.dirichlet(np.full(k, alpha_theta), size=n_genes).astype(np.float64)
    p = rng.dirichlet(np.full(n_ratings, alpha_p), size=(k,) * arity).astype(
        np.float64
    )
    return theta, p


def sample_synthetic_dataset(
    n_triplets: int,
    n_genes: int,
    k: int,
    n_ratings: int = 2,
    alpha_theta: float = 0.5,
    alpha_p: float = 0.5,
    seed: int = 0,
    theta: Optional[np.ndarray] = None,
    p: Optional[np.ndarray] = None,
    arity: int = 3,
) -> Tuple[TripletDataset, np.ndarray, np.ndarray]:
    """Sample gene tuples of distinct genes and ratings from the MMSBM.

    Returns (dataset, theta*, p*).  Rating sampling follows the §1.2
    likelihood exactly: group memberships (one per gene slot) ~ theta rows,
    then r ~ p[z..., :].  ``arity=2`` samples the pairwise (digenic)
    family.
    """
    rng = np.random.default_rng(seed + 1)
    if theta is None or p is None:
        theta, p = sample_ground_truth(
            n_genes, k, n_ratings, alpha_theta, alpha_p, seed, arity=arity
        )
    arity = p.ndim - 1

    # Distinct genes per tuple via vectorized rejection.
    def _any_dup(t: np.ndarray) -> np.ndarray:
        dup = np.zeros(t.shape[0], dtype=bool)
        for i in range(arity):
            for j in range(i + 1, arity):
                dup |= t[:, i] == t[:, j]
        return dup

    trip = rng.integers(0, n_genes, size=(n_triplets, arity), dtype=np.int64)
    bad = _any_dup(trip)
    while np.any(bad):
        trip[bad] = rng.integers(0, n_genes, size=(int(bad.sum()), arity))
        bad = _any_dup(trip)

    # Vectorized categorical draws via inverse-CDF on uniforms.
    def _draw(probs: np.ndarray) -> np.ndarray:
        cdf = np.cumsum(probs, axis=-1)
        u = rng.random(probs.shape[0])[:, None]
        return (u > cdf[:, :-1]).sum(axis=1).astype(np.int64)

    zs = tuple(_draw(theta[trip[:, pos]]) for pos in range(arity))
    ratings = _draw(p[zs])

    ds = TripletDataset(
        triplets=trip.astype(np.int32),
        ratings=ratings.astype(np.int32),
        weights=np.ones(n_triplets, dtype=np.float32),
        n_genes=n_genes,
        n_ratings=n_ratings,
        gene_names=[f"YSYN{i:05d}C" for i in range(n_genes)],
    )
    return ds, theta, p


def write_kuzmin_like_tsv(
    path: str,
    n_rows: int = 200,
    n_genes: int = 30,
    seed: int = 0,
    p_cutoff: float = 0.05,
    tau_cutoff: float = 0.08,
) -> int:
    """Write a Data-S1-shaped TSV (with digenic rows and allele suffixes)
    for loader round-trip tests.  Digenic rows carry the ho-delta control
    (YDL227C) in one query slot, as in the real screen, so the digenic
    loader mode can extract (query gene, array gene) pairs from them.
    Returns the number of trigenic rows whose label binarizes to 1 under
    the default cutoffs."""
    rng = np.random.default_rng(seed)
    control = "YDL227C"
    genes = [f"YA{i:03d}W" for i in range(n_genes)]
    header = [
        "Query strain ID",
        "Array strain ID",
        "Combined mutant type",
        "Raw genetic interaction score (epsilon)",
        "Adjusted genetic interaction score (epsilon or tau)",
        "P-value",
        "Query single/double mutant fitness",
        "Array single mutant fitness",
    ]
    n_pos = 0
    with open(path, "w") as fh:
        fh.write("\t".join(header) + "\n")
        for _ in range(n_rows):
            a, b, c = rng.choice(n_genes, size=3, replace=False)
            is_tri = rng.random() < 0.8
            tau = float(rng.normal(0, 0.12))
            pval = float(rng.random() * 0.2)
            suffix_a = "-del1" if rng.random() < 0.3 else ""
            suffix_b = "_ts2" if rng.random() < 0.3 else ""
            second = genes[b] if is_tri else control
            query = f"{genes[a].lower()}{suffix_a}+{second.lower()}{suffix_b}"
            row = [
                query,
                genes[c].lower(),
                "trigenic" if is_tri else "digenic",
                f"{tau * 1.1:.4f}",
                f"{tau:.4f}",
                f"{pval:.4f}",
                f"{rng.random():.3f}",
                f"{rng.random():.3f}",
            ]
            fh.write("\t".join(row) + "\n")
            if is_tri and pval < p_cutoff and abs(tau) > tau_cutoff:
                n_pos += 1
    return n_pos
