"""MMSBM model state as a dataclass of tensors (counterpart of the
reference's ``models/mmsbm.py``).

Simplex invariants, as in the reference:
- every row ``theta[..., g, :]`` sums to 1 and is non-negative;
- every cell ``p[..., k, l, m, :]`` sums to 1 over ratings and is non-negative.

The initial draw comes from a seeded ``numpy.random.Generator``: torch's
Dirichlet sampler takes no generator, and the reference's threefry draws
cannot be reproduced anyway, so parity tests hand both packages the same
initial arrays (:func:`state_from_numpy`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class ModelState:
    """Parameters of the tensorial MMSBM.

    theta: f32[..., G, K]            per-gene mixed membership
    p:     f32[..., K, ..., K, R]    one K axis per gene position: [K, K, K, R]
                                     (trigenic) or [K, K, R] (digenic)

    A leading restart axis [S] on both is the ensemble form.
    """

    theta: torch.Tensor
    p: torch.Tensor

    @property
    def n_genes(self) -> int:
        return self.theta.shape[-2]

    @property
    def k(self) -> int:
        return self.theta.shape[-1]

    @property
    def n_ratings(self) -> int:
        return self.p.shape[-1]

    @property
    def arity(self) -> int:
        """Gene positions per observation (number of K axes on p)."""
        return self.p.dim() - (self.theta.dim() - 2) - 1

    @property
    def device(self) -> torch.device:
        return self.theta.device

    def numpy(self):
        """(theta, p) as host numpy arrays -- the format both packages share."""
        return to_numpy(self.theta), to_numpy(self.p)


def to_numpy(x) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fresh_f32(x, device) -> torch.Tensor:
    """A new contiguous float32 copy of ``x`` on ``device``; a tensor is
    copied straight to it, with no trip through host memory."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=torch.float32, device=device).copy_(x.detach())
    return torch.as_tensor(np.asarray(x).astype(np.float32), device=device)


def state_from_numpy(theta, p, device="cpu") -> ModelState:
    """Carry (theta, p) arrays or tensors -- e.g. the JAX package's
    parameters, a checkpoint's, or states drawn on the card -- into the
    port as new float32 tensors on ``device``."""
    return ModelState(theta=_fresh_f32(theta, device), p=_fresh_f32(p, device))


def init_state(
    n_genes: int,
    k: int,
    n_ratings: int = 2,
    alpha: float = 1.0,
    arity: int = 3,
    samples: Optional[int] = None,
    seed: int = 0,
    device="cpu",
) -> ModelState:
    """Random simplex initialization: Dirichlet(alpha) theta rows and p
    cells (alpha = 1 is the uniform simplex), drawn from
    ``numpy.random.default_rng(seed)``.  ``samples`` adds a leading restart
    axis of independent draws.
    """
    rng = np.random.default_rng(seed)
    lead = () if samples is None else (samples,)
    theta = rng.dirichlet(np.full(k, alpha), size=lead + (n_genes,))
    p = rng.dirichlet(np.full(n_ratings, alpha), size=lead + (k,) * arity)
    return state_from_numpy(theta, p, device)
