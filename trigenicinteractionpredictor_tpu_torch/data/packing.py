"""Packed gene-tuple arrays — the device-resident dataset format (layer L1).

The reference keeps the dataset as Python dicts and lists of triplets
(SURVEY.md §2 L1).  The TPU-native format is three dense arrays, padded to a
static shape so every jit compiles once:

- ``triplets``: int32[N, arity] — dense gene ids per observation (arity 3
  for trigenic rows, the reference's only mode; arity 2 for the digenic
  rows the same Data S1 file carries, fit by the pairwise MMSBM family)
- ``ratings``:  int32[N]    — rating class in [0, R)
- ``weights``:  float32[N]  — 1.0 for real rows, 0.0 for padding

plus host-side metadata (gene name table, per-gene degrees).  Gene ids are
content-derived (sorted gene names), not first-seen order, so folds are
reproducible across hosts (SURVEY.md §4.3).

The port's own copy of the reference's ``data/packing.py`` (as are
``splits.py`` and ``synthetic.py`` beside it): plain NumPy, the same
arrays and on-disk layouts (``save_npz``, ``save_dir``) in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _round_up(n: int, multiple: int) -> int:
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class TripletDataset:
    """A packed, optionally padded set of (gene, ..., gene, rating) rows.

    ``triplets`` is int32[N, arity]: arity 3 for trigenic observations,
    arity 2 for digenic pairs (same container, the EM engine dispatches on
    the static column count).
    """

    triplets: np.ndarray          # int32 [N, arity]
    ratings: np.ndarray           # int32 [N]
    weights: np.ndarray           # float32 [N]; 0.0 marks padding rows
    n_genes: int
    n_ratings: int
    gene_names: Optional[List[str]] = None

    def __post_init__(self):
        self.triplets = np.asarray(self.triplets, dtype=np.int32)
        self.ratings = np.asarray(self.ratings, dtype=np.int32)
        if self.weights is None:
            self.weights = np.ones(len(self.ratings), dtype=np.float32)
        self.weights = np.asarray(self.weights, dtype=np.float32)
        assert self.triplets.ndim == 2 and self.triplets.shape[1] in (2, 3)
        assert len(self.ratings) == len(self.triplets) == len(self.weights)

    # ------------------------------------------------------------------
    @property
    def arity(self) -> int:
        """Genes per observation: 3 (trigenic) or 2 (digenic)."""
        return int(self.triplets.shape[1])

    @property
    def n_rows(self) -> int:
        """Padded row count (the static shape)."""
        return int(self.triplets.shape[0])

    # Row-chunk size for host passes over possibly-memmapped arrays: large
    # enough to amortize, small enough that a beyond-host-RAM dataset never
    # materializes more than ~few-MB per pass (SURVEY.md §6 long-context).
    _HOST_CHUNK = 1 << 20

    @property
    def n_real(self) -> int:
        """Number of real (unpadded) observations (streams memmaps)."""
        c = self._HOST_CHUNK
        return int(
            sum(
                int(np.count_nonzero(self.weights[i : i + c] > 0))
                for i in range(0, self.n_rows, c)
            )
        )

    def weight_total(self) -> float:
        """Sum of row weights (f64 accumulation; streams memmaps)."""
        c = self._HOST_CHUNK
        return float(
            sum(
                np.sum(self.weights[i : i + c], dtype=np.float64)
                for i in range(0, self.n_rows, c)
            )
        )

    def degrees(self) -> np.ndarray:
        """Per-gene degree d(g): number of real rows containing g.

        Used to normalize theta rows after the M-step; computed over the
        *training* rows of the active split only (SURVEY.md §8.4 risk 6),
        so call this on the already-selected training subset.  Accumulated
        in row chunks so a memory-mapped beyond-RAM dataset streams through
        without a whole-array boolean mask or fancy-index copy.
        """
        deg = np.zeros(self.n_genes, dtype=np.int64)
        c = self._HOST_CHUNK
        for i in range(0, self.n_rows, c):
            trip = np.asarray(self.triplets[i : i + c])
            real = np.asarray(self.weights[i : i + c]) > 0
            deg += np.bincount(
                trip[real].reshape(-1), minlength=self.n_genes
            )
        return deg.astype(np.int32)

    # ------------------------------------------------------------------
    def select(self, idx: np.ndarray) -> "TripletDataset":
        """Row subset (real rows only; drops padding)."""
        return dataclasses.replace(
            self,
            triplets=self.triplets[idx],
            ratings=self.ratings[idx],
            weights=self.weights[idx],
        )

    def pad_to(self, multiple: int) -> "TripletDataset":
        """Pad rows to a multiple with weight-0 rows (gene 0, rating 0).

        Padding rows contribute nothing anywhere because every sum in the
        EM engine is weighted.
        """
        n = self.n_rows
        target = _round_up(max(n, 1), multiple)
        if target == n:
            return self
        pad = target - n
        return dataclasses.replace(
            self,
            triplets=np.concatenate(
                [self.triplets, np.zeros((pad, self.arity), dtype=np.int32)]
            ),
            ratings=np.concatenate([self.ratings, np.zeros(pad, dtype=np.int32)]),
            weights=np.concatenate([self.weights, np.zeros(pad, dtype=np.float32)]),
        )

    def sorted_by_gene(self, position: int = 0) -> "TripletDataset":
        """Stable sort rows by the gene id at a position.

        Makes the segment-sum in the M-step contiguous (SURVEY.md §8.4
        risk 1).  Padding rows sort wherever gene 0 lands, which is fine —
        they are weight-0.
        """
        order = np.argsort(self.triplets[:, position], kind="stable")
        return self.select(order)

    # ------------------------------------------------------------------
    @staticmethod
    def from_rows(
        rows: Sequence[Tuple],
        n_ratings: int = 2,
        gene_names: Optional[Sequence[str]] = None,
        arity: int = 3,
    ) -> "TripletDataset":
        """Build from (gene, ..., gene, rating) name rows.

        Each row is ``arity`` gene names followed by an int rating (arity
        inferred from the first row when rows are present).  Ids are
        assigned by sorted gene name (content-derived, deterministic across
        hosts and row orders).
        """
        if rows:
            arity = len(rows[0]) - 1
        assert arity in (2, 3), arity
        if gene_names is None:
            names = sorted({g for row in rows for g in row[:arity]})
        else:
            names = list(gene_names)
        index = {g: i for i, g in enumerate(names)}
        trip = np.array(
            [[index[g] for g in row[:arity]] for row in rows], dtype=np.int32
        ).reshape(-1, arity)
        ratings = np.array([row[arity] for row in rows], dtype=np.int32)
        return TripletDataset(
            triplets=trip,
            ratings=ratings,
            weights=np.ones(len(rows), dtype=np.float32),
            n_genes=len(names),
            n_ratings=n_ratings,
            gene_names=names,
        )

    # ------------------------------------------------------------------
    def save_npz(self, path: str) -> str:
        """Write the packed container; returns the ACTUAL path written
        (np.savez appends ``.npz`` to names that lack it — returning the
        real name keeps CLI output and chained ``-f`` usage truthful)."""
        np.savez_compressed(
            path,
            triplets=self.triplets,
            ratings=self.ratings,
            weights=self.weights,
            n_genes=np.int32(self.n_genes),
            n_ratings=np.int32(self.n_ratings),
            gene_names=np.array(self.gene_names or [], dtype=object),
        )
        return path if path.endswith(".npz") else path + ".npz"

    def save_dir(self, path: str) -> None:
        """Save as raw .npy files — the memory-mappable on-disk layout for
        the beyond-HBM streaming loader (load_dir(mmap=True)).  Unlike the
        zipped .npz container, each array can be np.memmap'd directly, so a
        dataset larger than device HBM (or even host RAM) streams epoch
        groups without ever materializing in full."""
        import json as _json
        import os as _os

        _os.makedirs(path, exist_ok=True)
        np.save(_os.path.join(path, "triplets.npy"), self.triplets)
        np.save(_os.path.join(path, "ratings.npy"), self.ratings)
        np.save(_os.path.join(path, "weights.npy"), self.weights)
        with open(_os.path.join(path, "meta.json"), "w") as fh:
            _json.dump(
                {
                    "n_genes": self.n_genes,
                    "n_ratings": self.n_ratings,
                    "gene_names": self.gene_names,
                },
                fh,
            )

    @staticmethod
    def load_dir(path: str, mmap: bool = True) -> "TripletDataset":
        """Load a save_dir() layout, memory-mapped read-only by default."""
        import json as _json
        import os as _os

        mode = "r" if mmap else None
        with open(_os.path.join(path, "meta.json")) as fh:
            meta = _json.load(fh)
        return TripletDataset(
            triplets=np.load(_os.path.join(path, "triplets.npy"), mmap_mode=mode),
            ratings=np.load(_os.path.join(path, "ratings.npy"), mmap_mode=mode),
            weights=np.load(_os.path.join(path, "weights.npy"), mmap_mode=mode),
            n_genes=meta["n_genes"],
            n_ratings=meta["n_ratings"],
            gene_names=meta["gene_names"],
        )

    @staticmethod
    def load_npz(path: str) -> "TripletDataset":
        with np.load(path, allow_pickle=True) as z:
            names = [str(x) for x in z["gene_names"]] or None
            return TripletDataset(
                triplets=z["triplets"],
                ratings=z["ratings"],
                weights=z["weights"],
                n_genes=int(z["n_genes"]),
                n_ratings=int(z["n_ratings"]),
                gene_names=names,
            )
