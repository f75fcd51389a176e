"""The plain reference of what the cells compute: whole EM fits of the
trigenic MMSBM and ensemble scoring, in plain PyTorch.

It follows the model's equations (Godoy-Lorite et al., PNAS 2016; the
trigenic form of the reference package), for one observation t = (i, j, e, r):

    D_t       = sum_klm theta[i,k] theta[j,l] theta[e,m] p[k,l,m,r]
    theta_hat = sum over t and positions of theta_pos * A_pos / D_t, by gene
    p_hat     = p * sum_t theta[i,k] theta[j,l] theta[e,m] / D_t  (rating r_t)
    L         = sum_t log D_t

then theta = theta_hat / degree (genes seen in no row keep their row) and
p = p_hat normalized over ratings (cells with no mass keep their old p).
Every row the benchmark makes has weight 1, so no weights appear here.

It imports nothing of the measured program and takes nothing it made:
it gets the benchmark's own rows and initial states and works the rest
out again.  ``precision="float64"`` is the reference.  ``precision="tf32"``
is the control: float32 storage with every matrix product's operands
rounded to TF32 (10 explicit mantissa bits, round to nearest), the step
below the float32-without-TF32 that the configurations state.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

_EPS = 1e-30
PRECISIONS = ("float64", "tf32")
_ELEMENTS = 1 << 27  # elements of one [S, rows, K^2] intermediate


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def _mm(a, b, precision: str):
    if precision == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    return torch.matmul(a, b)


class DeviceRows(NamedTuple):
    """Training rows on the device, grouped by rating: ``groups[r]`` holds
    the int64 [B_r, 3] gene ids of the rows rated r."""

    groups: List[torch.Tensor]
    degrees: torch.Tensor  # [G] rows that contain each gene


def device_rows(triplets, ratings, n_genes: int, n_ratings: int, device) -> DeviceRows:
    trip = torch.as_tensor(triplets, device=device).long()
    rat = torch.as_tensor(ratings, device=device).long()
    groups = [trip[rat == r].contiguous() for r in range(n_ratings)]
    deg = torch.bincount(trip.reshape(-1), minlength=n_genes)
    return DeviceRows(groups, deg)


def _chunks(trip: torch.Tensor, s: int, k: int):
    step = max(256, _ELEMENTS // (s * k * k))
    return (trip[i:i + step] for i in range(0, trip.shape[0], step))


def sweep(theta, p, rows: DeviceRows, precision: str, stats: bool = True):
    """One EM sweep of every restart: (theta, p, L of the given state [S]);
    with ``stats=False`` only L, the states returned as they came."""
    S, _, K = theta.shape
    theta_hat = torch.zeros_like(theta)
    cross = torch.zeros_like(p)
    ll = torch.zeros(S, dtype=theta.dtype, device=theta.device)
    for r, trip in enumerate(rows.groups):
        pr = p[..., r]                                          # [S, k, l, m]
        p_m = pr.permute(0, 3, 1, 2).reshape(S, K, K * K)       # [S, m, kl]
        p_kl = pr.reshape(S, K * K, K)                          # [S, kl, m]
        for t in _chunks(trip, S, K):
            th1, th2, th3 = (theta[:, t[:, q]] for q in range(3))   # [S, B, K]
            B = t.shape[0]
            T = _mm(th3, p_m, precision).view(S, B, K, K)        # sum_m th3 p
            A1 = _mm(T, th2.unsqueeze(-1), precision).squeeze(-1)
            D = (th1 * A1).sum(-1) + _EPS
            ll += torch.log(D).sum(-1)
            if not stats:
                continue
            A2 = _mm(th1.unsqueeze(-2), T, precision).squeeze(-2)
            del T
            W = (th1.unsqueeze(-1) * th2.unsqueeze(-2)).reshape(S, B, K * K)
            A3 = _mm(W, p_kl, precision)
            sc = (1.0 / D).unsqueeze(-1)
            for q, (th, a) in enumerate(((th1, A1), (th2, A2), (th3, A3))):
                theta_hat.index_add_(1, t[:, q], th * a * sc)
            cross[..., r] += _mm((W * sc).transpose(1, 2), th3, precision).view(S, K, K, K)
    if not stats:
        return theta, p, ll
    deg = rows.degrees.to(theta.dtype)
    theta_new = theta_hat / torch.clamp(deg, min=_EPS)[:, None]
    theta = torch.where((deg > 0)[:, None], theta_new, theta)
    p_hat = p * cross
    mass = p_hat.sum(-1, keepdim=True)
    p = torch.where(mass > _EPS, p_hat / (mass + _EPS), p)
    return theta, p, ll


class Fit(NamedTuple):
    theta: torch.Tensor
    p: torch.Tensor
    ll_trace: torch.Tensor   # [sweeps // freq, S]: L before each check's last sweep
    final_ll: torch.Tensor   # [S]: L of the final states


def fit(theta0, p0, rows: DeviceRows, sweeps: int, freq: int, precision: str) -> Fit:
    """``sweeps`` EM sweeps from (theta0, p0), recording every ``freq``-th
    sweep's L of the state it started from, then the final states' L."""
    dt = _dtype(precision)
    theta, p = theta0.to(dt), p0.to(dt)
    trace = []
    for i in range(sweeps):
        theta, p, ll = sweep(theta, p, rows, precision)
        if (i + 1) % freq == 0 or i + 1 == sweeps:
            trace.append(ll)
    final = sweep(theta, p, rows, precision, stats=False)[2]
    return Fit(theta, p, torch.stack(trace), final)


def ensemble_scores(theta, p, triplets, rating: int, precision: str) -> torch.Tensor:
    """P(rating | genes) averaged over the restarts, for every row of
    ``triplets`` (int [B, 3] on theta's device)."""
    dt = _dtype(precision)
    theta, p = theta.to(dt), p.to(dt)
    S, _, K = theta.shape
    p_kl = p[..., rating].reshape(S, K * K, K)
    out = []
    for t in _chunks(triplets.long(), S, K):
        th1, th2, th3 = (theta[:, t[:, q]] for q in range(3))
        W = (th1.unsqueeze(-1) * th2.unsqueeze(-2)).reshape(S, t.shape[0], K * K)
        A3 = _mm(W, p_kl, precision)
        out.append((A3 * th3).sum(-1).mean(0))
    return torch.cat(out)
