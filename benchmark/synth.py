"""Inputs made from ``--seed``: planted-MMSBM triplets, the 80/20 split,
initial ensembles and candidate triplets.

The triplet generator and the split are frozen copies of the math of the
program's ``data/synthetic.py::sample_synthetic_dataset`` and
``data/splits.py::train_test_split`` (plain NumPy), with one generator
per purpose derived from the seed, so that no later change to the program
changes the benchmark's inputs.  Initial states and candidates are drawn
on the run's device from a seeded ``torch.Generator`` in a few large
calls.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Streams derived from one seed, one per purpose.
DATA, INIT, SAMPLE, POOL, STATES = range(5)


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, *stream]))


def torch_generator(device, seed: int, *stream: int) -> torch.Generator:
    word = int(np.random.SeedSequence([seed % 2**64, *stream]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(word & (2**63 - 1))


class Rows(NamedTuple):
    triplets: np.ndarray  # int32 [N, 3], three distinct genes a row
    ratings: np.ndarray   # int32 [N]


def planted_rows(n: int, g: int, k: int, r: int, alpha_theta: float, alpha_p: float,
                 seed: int) -> Rows:
    """``n`` triplets of distinct genes with ratings drawn from a planted
    MMSBM: theta* rows ~ Dirichlet(alpha_theta), p* cells ~
    Dirichlet(alpha_p); each gene slot draws a group from its theta* row,
    the rating from p* at the three groups."""
    gen = rng(seed, DATA)
    theta = gen.dirichlet(np.full(k, alpha_theta), size=g)
    p = gen.dirichlet(np.full(r, alpha_p), size=(k, k, k))

    def any_dup(t):
        return (t[:, 0] == t[:, 1]) | (t[:, 0] == t[:, 2]) | (t[:, 1] == t[:, 2])

    trip = gen.integers(0, g, size=(n, 3), dtype=np.int64)
    bad = any_dup(trip)
    while np.any(bad):
        trip[bad] = gen.integers(0, g, size=(int(bad.sum()), 3))
        bad = any_dup(trip)

    def draw(probs):
        cdf = np.cumsum(probs, axis=-1)
        u = gen.random(probs.shape[0])[:, None]
        return (u > cdf[:, :-1]).sum(axis=1)

    zs = tuple(draw(theta[trip[:, pos]]) for pos in range(3))
    ratings = draw(p[zs])
    return Rows(trip.astype(np.int32), ratings.astype(np.int32))


def train_rows(rows: Rows, test_fraction: float, seed: int) -> Rows:
    """The training side of a seeded split: a permutation, the first
    ``round(n * test_fraction)`` rows held out, the rest in row order."""
    n = rows.triplets.shape[0]
    perm = rng(seed, DATA, 1).permutation(n)
    keep = np.sort(perm[int(round(n * test_fraction)):])
    return Rows(rows.triplets[keep], rows.ratings[keep])


def simplex(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Dirichlet(1) vectors along the last axis (normalized exponentials),
    float32 on ``device``."""
    e = torch.empty(shape, dtype=torch.float32, device=device).exponential_(generator=gen)
    return e / e.sum(-1, keepdim=True)


def ensemble(s: int, g: int, k: int, r: int, gen: torch.Generator, device):
    """(theta [S, G, K], p [S, K, K, K, R]) of uniform-simplex rows and cells."""
    return simplex((s, g, k), gen, device), simplex((s, k, k, k, r), gen, device)


def distinct_triplets(n: int, g: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` ordered triplets of three distinct genes, uniform over all of
    them (no rejection: the second and third draws skip the genes taken)."""
    a = torch.randint(0, g, (n,), generator=gen, device=device)
    b = torch.randint(0, g - 1, (n,), generator=gen, device=device)
    b = b + (b >= a).long()
    c = torch.randint(0, g - 2, (n,), generator=gen, device=device)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    c = c + (c >= lo).long()
    c = c + (c >= hi).long()
    return torch.stack([a, b, c], 1).to(torch.int32)


class Reservoir:
    """A uniform sample of at most ``size`` of the offered (key, value)
    pairs, without knowing how many will come, drawn from ``gen``."""

    def __init__(self, size: int, gen: np.random.Generator):
        self.size, self.gen, self.seen, self.items = size, gen, 0, []

    def offer(self, key, value) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append((key, value))
        else:
            j = int(self.gen.integers(0, self.seen))
            if j < self.size:
                self.items[j] = (key, value)
