"""Operations, bytes and the least time of the benchmark's kernels, from
their shapes alone (frozen copies of ``chip_smoke.py``'s ``_bound``,
``_sweep_flops``, ``_sweep_bytes`` and K2's one-rating count).

The peaks are NVIDIA's published H100 SXM rates at 700 W: float32 outside
the tensor cores, and device-memory bandwidth.  A card set below 700 W
runs slower under load; the harness prints the power limit beside every
run.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float):
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops, t_mem = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def sweep_flops(rows: int, k: int, s: int) -> float:
    """One EM sweep's float32 operations: per real row and restart, T = th3 p
    and A3 = (th1 th2) p (K^3 multiply-adds each, the row's rating only),
    the cross-stats (K^3), A1, A2, W (K^2 each) and D."""
    return 2.0 * rows * s * (3 * k**3 + 3 * k**2 + k)


def sweep_bytes(b: int, g: int, k: int, r: int, s: int, theta_in=None, extra=0) -> float:
    """A sweep's bytes, each input read once and each output written once:
    theta (or ``theta_in`` bytes of pre-gathered rows), p, 20 bytes a row
    (3 ids, rating, weight), theta_hat, p_hat, loglik, and ``extra``."""
    theta, p = 4.0 * s * g * k, 4.0 * s * k**3 * r
    return (theta if theta_in is None else theta_in) + p + 20.0 * b + theta + p + 4 * s + extra


def score_flops(rows: int, k: int, s: int) -> float:
    """Ensemble scoring of one rating: per row and restart sum_m th3 p is
    K^3 multiply-adds, then K^2 over l and K over k."""
    return 2.0 * rows * s * (k**3 + k**2 + k)


def score_bytes(rows: int, g: int, k: int, s: int) -> float:
    """Scoring's bytes: theta, one rating's slice of p, 12 bytes of ids in
    and 4 of score out a row."""
    return 4.0 * s * g * k + 4.0 * s * k**3 + 16.0 * rows
