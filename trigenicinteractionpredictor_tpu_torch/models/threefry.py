"""The reference's seeded restart draw, in numpy.

The reference draws a restart ensemble as ``jax.random.split(key(seed), S)``
and, per restart, Dirichlet theta rows and p cells from ``jax.random.dirichlet``
(threefry2x32 counter hashing in its partitionable form, Marsaglia-Tsang
gamma variates in log space, a float32 softmax).  :func:`reference_init_states`
repeats those steps here, so the port can start from the very states a
reference run at ``seed`` starts from.  Every integer step is the
reference's bit for bit; the float32 steps agree to a few ulps (XLA fuses
multiply-adds that numpy rounds twice, and its ``erf_inv`` is the polynomial
:func:`_erf_inv` evaluates), so a rejection step may in principle decide
otherwise at a tie; ``tests/test_torch_bench.py`` holds the draw to the
reference's.

The port's own ``models/mmsbm.py::init_state`` draws from numpy's
generator; this module exists for the quality bench (``bench_quality.py``),
whose records (``tests/perf_records.json`` -> ``quality``) were measured
from the reference's seed: how many sweeps the held-out AUC takes to settle
depends on the draw as much as on the engine.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState, state_from_numpy

_U32 = np.uint32
_F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Giles' single-precision erfinv, as XLA evaluates it: w < 5, then w >= 5.
_ERFINV_W5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                       0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                       1.50140941], _F32)
_ERFINV_WG = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                       0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                       2.83297682], _F32)


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of counters (x1, x2) under keys
    (k1, k2); uint32 arrays, broadcast."""
    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, _U32) for a in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    a, b = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = ((b << _U32(r)) | (b >> _U32(32 - r))) ^ a
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data: uint32 [2]."""
    if not 0 <= seed < 2**63:
        raise ValueError(f"seed must lie in [0, 2**63), got {seed}")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], _U32)


def split(keys: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` of each key in ``keys`` [..., 2]: [..., num, 2]."""
    b1, b2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], 0,
                          np.arange(num, dtype=_U32))
    return np.stack([b1, b2], axis=-1)


def _uniform(keys: np.ndarray, lo, hi) -> np.ndarray:
    """One float32 uniform in [lo, hi) per key (``jax.random.uniform``, shape ())."""
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], 0, 0)
    floats = (((b1 ^ b2) >> _U32(9)) | _U32(0x3F800000)).view(_F32) - _F32(1)
    lo, hi = _F32(lo), _F32(hi)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function, for |x| < 1."""
    w = -np.log1p(-x * x)
    small = w < _F32(5)
    w = np.where(small, w - _F32(2.5), np.sqrt(w) - _F32(3))
    p = np.where(small, _ERFINV_W5[0], _ERFINV_WG[0])
    for c5, cg in zip(_ERFINV_W5[1:], _ERFINV_WG[1:]):
        p = np.where(small, c5, cg) + p * w
    return p * x


def _normal(keys: np.ndarray) -> np.ndarray:
    """One float32 standard normal per key (``jax.random.normal``, shape ())."""
    u = _uniform(keys, np.nextafter(_F32(-1), _F32(0)), 1)
    return _F32(np.sqrt(2)) * _erf_inv(u)


def _log_gamma(keys: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """One log Gamma(alpha) variate per key: the reference's Marsaglia-Tsang
    loop in log space (alpha < 1 boosted to alpha + 1), all keys at once."""
    one, third = _F32(1), _F32(1 / 3)
    boost = alpha >= one
    a = np.where(boost, alpha, alpha + one)
    d = a - third
    c = third / np.sqrt(d)
    pair = split(keys)
    keys, subkeys = pair[:, 0].copy(), pair[:, 1]
    X = np.zeros_like(alpha)
    V = np.ones_like(alpha)
    todo = np.arange(alpha.shape[0])
    while todo.size:
        k3 = split(keys[todo], 3)
        keys[todo] = k3[:, 0]
        x_keys, u_keys = k3[:, 1].copy(), k3[:, 2]
        x = np.zeros(todo.size, _F32)
        v = np.full(todo.size, -one)
        redo = np.arange(todo.size)
        while redo.size:  # draw x until v = 1 + c x > 0
            kk = split(x_keys[redo])
            x_keys[redo] = kk[:, 0]
            x[redo] = _normal(kk[:, 1])
            v[redo] = one + x[redo] * c[todo[redo]]
            redo = redo[v[redo] <= 0]
        X[todo], V[todo] = x * x, v * v * v
        u = _uniform(u_keys, 0, 1)
        xx, vv, dd = X[todo], V[todo], d[todo]
        with np.errstate(invalid="ignore", divide="ignore"):
            again = ((u >= one - _F32(0.0331) * (xx * xx))
                     & (np.log(u) >= xx * _F32(0.5) + dd * ((one - vv) + np.log(vv))))
        todo = todo[again]
    log_u = np.log1p(-_uniform(subkeys, 0, 1))  # -Exponential()
    with np.errstate(divide="ignore"):
        log_boost = np.where(boost | (log_u == 0), _F32(0), log_u * (one / alpha))
    return np.log(d) + np.log(V) + log_boost


def dirichlet(k: np.ndarray, alpha: float, n_cat: int, shape: tuple) -> np.ndarray:
    """``jax.random.dirichlet(k, full(n_cat, alpha), shape)``: float32
    [*shape, n_cat]."""
    n = int(np.prod(shape, dtype=np.int64)) * n_cat
    logs = _log_gamma(split(k, n), np.full(n, alpha, _F32)).reshape(*shape, n_cat)
    e = np.exp(logs - logs.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def reference_init_states(seed: int, samples: int, n_genes: int, k: int, n_ratings: int = 2,
                          alpha: float = 1.0, arity: int = 3, device="cpu") -> ModelState:
    """The reference's ``vmap(init_state)(split(key(seed), samples))`` on
    ``device``: theta [S, G, K] and p [S, K, ..., K, R]."""
    thetas, ps = [], []
    for restart in split(key(seed), samples):
        k_theta, k_p = split(restart)
        thetas.append(dirichlet(k_theta, alpha, k, (n_genes,)))
        ps.append(dirichlet(k_p, alpha, n_ratings, (k,) * arity))
    return state_from_numpy(np.stack(thetas), np.stack(ps), device)
