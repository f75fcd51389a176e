"""PyTorch port vs the JAX reference at large K, on the CPU: the plain
version of the K3 sweep kernel (ops/em_large_k.py) against the reference's
one-hot sweep kernel (ops/pallas_em.py, interpret mode) in its ensemble,
grouped and single-restart forms, and against the bdrg kernel
(ops/pallas_em_bdrg.py) in its K = 56..64 regime; the row-chunked plain
sweep; K3's host plan and the route chooser; and a fit at K = 24.

The same inputs, made with numpy from a seed, go through both packages.
Tolerances are the reference's own (tests/test_kernel_parity.py:50-58):
theta_hat atol 1e-4, p_hat atol 1e-5, loglik rtol 1e-5; a fit's final L
rtol 1e-4 (tests/test_backend_dispatch.py:120-122).  Chunked against
unchunked is the same float32 sum in another grouping of a few hundred
rows, so it agrees to a few float32 ulps: rtol 2e-6 (atol 1e-6) on
theta_hat and p_hat, rtol 1e-5 on loglik.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trigenicinteractionpredictor_tpu.config import Config, EngineConfig, TrainConfig
from trigenicinteractionpredictor_tpu.data.splits import train_test_split
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState as JState
from trigenicinteractionpredictor_tpu.ops import em as jem
from trigenicinteractionpredictor_tpu.train.trainer import fit as jfit
from trigenicinteractionpredictor_tpu.utils.logging import JsonlLogger
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu_torch.ops import dispatch, em_bdr, em_large_k
from trigenicinteractionpredictor_tpu_torch.ops import em as tem
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit

torch.set_num_threads(2)

THETA_ATOL = 1e-4   # reference tests/test_kernel_parity.py:50-52
P_ATOL = 1e-5       # reference tests/test_kernel_parity.py:53-55
LL_RTOL = 1e-5      # reference tests/test_kernel_parity.py:56-58
FIT_RTOL = 1e-4     # reference tests/test_backend_dispatch.py:120-122
QUIET = JsonlLogger(None, echo=False)


def _case(n, g, k, r, s, seed, pad_to=None, arity=3):
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=r, seed=seed, arity=arity)
    if pad_to:
        ds = ds.pad_to(pad_to)
    st = init_state(g, k, r, samples=s, seed=seed + 1, arity=arity)
    jb = jem.Batch(
        triplets=jnp.asarray(ds.triplets),
        ratings=jnp.asarray(ds.ratings),
        weights=jnp.asarray(ds.weights),
    )
    tb = tem.make_batch(ds.triplets, ds.ratings, ds.weights, "cpu")
    return ds, st, jb, tb


def _assert_stats(out, theta_hat, p_hat, loglik):
    np.testing.assert_allclose(out.theta_hat.numpy(), np.asarray(theta_hat), atol=THETA_ATOL)
    np.testing.assert_allclose(out.p_hat.numpy(), np.asarray(p_hat), atol=P_ATOL)
    np.testing.assert_allclose(out.loglik.numpy(), np.asarray(loglik), rtol=LL_RTOL)


def _k3_plain(st, tb, row_chunk):
    """K3's wrapper on CPU tensors: its plain version, with no launch."""
    launches = em_large_k.em_ensemble_stats.launches
    out = em_large_k.em_ensemble_stats(st.theta, st.p, tb, row_chunk=row_chunk)
    assert em_large_k.em_ensemble_stats.launches == launches
    return out


@pytest.mark.parametrize("row_chunk", [0, 128])
@pytest.mark.parametrize(
    "n,g,k,r,s,tile",
    [
        (512, 40, 21, 2, 3, 256),
        (300, 32, 24, 3, 2, 128),   # ragged: pads 300 -> 384, R = 3
    ],
)
def test_k3_plain_matches_onehot_ensemble_kernel(n, g, k, r, s, tile, row_chunk):
    """The reference's ``pallas-onehot-ensemble`` route (K = 21..32)."""
    from trigenicinteractionpredictor_tpu.ops.pallas_em import pallas_em_ensemble_stats

    ds, st, jb, tb = _case(n, g, k, r, s, seed=k, pad_to=tile)
    th, p = st.numpy()
    want = pallas_em_ensemble_stats(jnp.asarray(th), jnp.asarray(p), jb, tile_b=tile,
                                    interpret=True)
    _assert_stats(_k3_plain(st, tb, row_chunk), *want)


def test_k3_plain_matches_grouped_kernel():
    """The reference's ``pallas-onehot-grouped`` route (K = 40, 50 at S = 10),
    here at K = 33 with restart groups of 2."""
    from trigenicinteractionpredictor_tpu.ops.dispatch import _pallas_grouped_fn

    ds, st, jb, tb = _case(256, 24, 33, 2, 4, seed=5)
    th, p = st.numpy()
    fn = _pallas_grouped_fn(128, 2)
    assert fn.kernel_name == "pallas-onehot-grouped"
    _assert_stats(_k3_plain(st, tb, 100), *fn(jnp.asarray(th), jnp.asarray(p), jb))


def test_k3_plain_matches_single_restart_kernel():
    """The reference's ``pallas-onehot-single`` route (K = 64), at K = 33."""
    from trigenicinteractionpredictor_tpu.ops.dispatch import _pallas_single_fn

    ds, st, jb, tb = _case(256, 24, 33, 3, 1, seed=6)
    th, p = st.numpy()
    fn = _pallas_single_fn(128)
    assert fn.kernel_name == "pallas-onehot-single"
    want = fn(jnp.asarray(th[0]), jnp.asarray(p[0]), jb)
    _assert_stats(_k3_plain(st, tb, 0), want.theta_hat[None], want.p_hat[None],
                  want.loglik[None])


@pytest.mark.parametrize("k,g", [(56, 2000), (64, 4000)])
def test_k3_plain_matches_bdrg_kernel(k, g):
    """The reference's ``pallas-bdrg`` regime (K8: K = 56..64 at G =
    2000..4000, where its dispatch leaves the one-hot kernels): K3's plain
    version on the rows as they come against the bdrg kernel in interpret
    mode on rating-sorted, padded rows -- the stats are order-free."""
    from trigenicinteractionpredictor_tpu.ops.pallas_em_bdrg import bdrg_em_ensemble_stats
    from trigenicinteractionpredictor_tpu.ops.pallas_em_rsorted import (
        apply_rating_sort,
        rating_sort_pad,
    )

    ds, st, _, tb = _case(200, g, k, 2, 2, seed=k)
    th, p = st.numpy()
    plan = rating_sort_pad(ds.ratings, 2, tile=64)
    t_, r_, w_ = apply_rating_sort(plan, ds.triplets, ds.ratings, ds.weights)
    sorted_batch = jem.Batch(
        triplets=jnp.asarray(t_), ratings=jnp.asarray(r_),
        weights=jnp.asarray(w_), tile_rating=jnp.asarray(plan.tile_r),
    )
    want = bdrg_em_ensemble_stats(jnp.asarray(th), jnp.asarray(p), sorted_batch,
                                  tile_b=64, group=1, interpret=True)
    _assert_stats(_k3_plain(st, tb, 0), *want)


@pytest.mark.parametrize("arity", [3, 2])
@pytest.mark.parametrize("row_chunk", [100, 128, 500])
def test_row_chunk_is_exact(arity, row_chunk):
    """The plain sweep summed over chunks that do (128) and do not (100,
    500) divide B = 384 equals the one-chunk sweep, in both arities, and
    matches the reference's chunked jnp stats."""
    ds, st, jb, tb = _case(300, 24, 4, 2, 3, seed=11, pad_to=128, arity=arity)
    whole = tem.em_sufficient_stats(st.theta, st.p, tb)
    chunked = tem.em_sufficient_stats(st.theta, st.p, tb, row_chunk=row_chunk)
    for name in ("theta_hat", "p_hat"):
        np.testing.assert_allclose(getattr(chunked, name).numpy(),
                                   getattr(whole, name).numpy(), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(chunked.loglik.numpy(), whole.loglik.numpy(), rtol=1e-5)
    th, p = st.numpy()
    want = jax.vmap(
        lambda a, b: jem.em_sufficient_stats(a, b, jb, row_chunk=row_chunk)
    )(th, p)
    _assert_stats(chunked, want.theta_hat, want.p_hat, want.loglik)


def test_plain_fit_receives_row_chunk(tmp_path, monkeypatch):
    """The trainer hands cfg.engine.jnp_row_chunk to the plain sweep, as the
    reference's trainer does (train/trainer.py:216-220), and records it."""
    seen = []
    real = tem.em_sufficient_stats

    def spy(theta, p, batch, row_chunk=0):
        seen.append(row_chunk)
        return real(theta, p, batch, row_chunk=row_chunk)

    monkeypatch.setattr(dispatch, "em_sufficient_stats", spy)
    ds, _, _ = sample_synthetic_dataset(400, 20, 3, n_ratings=2, seed=2)
    cfg = Config(train=TrainConfig(k=3, sweeps=4, samples=2, likelihood_freq=2),
                 engine=EngineConfig(jnp_row_chunk=96), out_dir=str(tmp_path))
    res = fit(cfg, ds, device="cpu", logger=QUIET)
    assert seen == [96] * 4
    assert res.dispatch["kernel"] == "torch" and res.dispatch["row_chunk"] == 96


def test_k3_sweep_plan_range():
    """K3's plan exists for every K in 21..64 at R = 2 and 3 within one
    block's shared memory and thread limit, and is None outside."""
    for k in range(21, 65):
        for r in (2, 3):
            plan = em_large_k.sweep_plan(k, r)
            assert plan is not None, (k, r)
            assert max(plan.estep_smem, plan.cross_smem) <= 232_448
            assert plan.cross_threads % 32 == 0 and plan.cross_threads <= 1024
    for k in (0, 10, 20, 65, 80):
        assert em_large_k.sweep_plan(k, 2) is None
    assert em_large_k.sweep_plan(50, 4) is None


@pytest.mark.parametrize(
    "device_type,arity,k,r,expected",
    [
        ("cuda", 3, 5, 2, em_bdr.KERNEL_NAME),
        ("cuda", 3, 20, 3, em_bdr.KERNEL_NAME),
        ("cuda", 3, 21, 2, em_large_k.KERNEL_NAME),
        ("cuda", 3, 50, 2, em_large_k.KERNEL_NAME),
        ("cuda", 3, 64, 3, em_large_k.KERNEL_NAME),
        ("cuda", 3, 65, 2, "torch"),
        ("cuda", 3, 80, 2, "torch"),
        ("cuda", 2, 50, 2, "torch"),
        ("cpu", 3, 10, 2, "torch"),
        ("cpu", 3, 50, 2, "torch"),
    ],
)
def test_route(device_type, arity, k, r, expected):
    assert dispatch.route(device_type, arity, k, r, 10) == expected
    fn = dispatch.resolve_stats_fn(device_type, arity, 1000, k, 10, n_ratings=r,
                                   row_chunk=16384)
    assert fn.kernel_name == expected
    if expected == "torch":
        assert fn.row_chunk == 16384


def test_fit_at_large_k_matches_jax_fit(tmp_path):
    """From the same initial arrays, the port's fit at K = 24 and the
    reference's fit land on the same final L."""
    ds, _, _ = sample_synthetic_dataset(600, 30, 4, n_ratings=2, seed=1)
    train, _ = train_test_split(ds, 0.2, seed=0)
    cfg = Config(train=TrainConfig(k=24, sweeps=10, samples=2, likelihood_freq=5),
                 engine=EngineConfig(backend="jnp"), out_dir=str(tmp_path))
    st = init_state(train.n_genes, 24, 2, samples=2, seed=3)
    th, p = st.numpy()
    jres = jfit(cfg, train, logger=QUIET, init_states=JState(theta=th, p=p))
    tres = fit(cfg, train, device="cpu", logger=QUIET, init_states=st)
    np.testing.assert_allclose(tres.final_loglik, jres.final_loglik, rtol=FIT_RTOL)
    np.testing.assert_allclose(tres.ll_trace, jres.ll_trace, rtol=FIT_RTOL)
