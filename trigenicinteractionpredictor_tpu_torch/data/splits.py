"""Seeded train/test splits and k-fold CV over the triplet list (layer L1).

The reference produces Kuzmin-style held-out splits and 5-fold CV with a
serial driver (SURVEY.md §2 "Train/test splitter", BASELINE configs 2-3).
Splits here are pure index permutations from a seeded NumPy generator, so a
(fold, seed) pair identifies the exact split on any host (SURVEY.md §8.4
risk 7).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset


def train_test_split(
    ds: TripletDataset, test_fraction: float = 0.2, seed: int = 0
) -> Tuple[TripletDataset, TripletDataset]:
    """Single seeded split, e.g. the 80/20 Kuzmin fold."""
    n = ds.n_rows
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = int(round(n * test_fraction))
    test_idx = np.sort(perm[:n_test])
    train_idx = np.sort(perm[n_test:])
    return ds.select(train_idx), ds.select(test_idx)


def kfold_splits(
    ds: TripletDataset, n_folds: int, seed: int = 0
) -> Iterator[Tuple[int, TripletDataset, TripletDataset]]:
    """Yield (fold_index, train, test) for seeded k-fold CV."""
    if n_folds < 2:
        raise ValueError("kfold_splits needs n_folds >= 2")
    n = ds.n_rows
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, n_folds)
    for f in range(n_folds):
        test_idx = np.sort(folds[f])
        train_idx = np.sort(np.concatenate([folds[i] for i in range(n_folds) if i != f]))
        yield f, ds.select(train_idx), ds.select(test_idx)
