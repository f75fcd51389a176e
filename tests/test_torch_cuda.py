"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no jax (nor does the port), so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the reference's kernel-parity ones (theta_hat atol 1e-4,
p_hat atol 1e-5, loglik rtol 1e-5; tests/test_kernel_parity.py:50-58) at
these small shapes, p_hat also rtol 1e-6; the pallas-scorer ones for
scores (rtol 3e-5, atol 3e-6; tests/test_metrics.py); and the fit ones
for a short fit (final L rtol 1e-4; tests/test_backend_dispatch.py:120-122).
"""

import dataclasses

import numpy as np
import pytest
import torch

from trigenicinteractionpredictor_tpu_torch import Config
from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState, init_state
from trigenicinteractionpredictor_tpu_torch.ops import em_bdr, em_large_k, score
from trigenicinteractionpredictor_tpu_torch.ops.dispatch import plain_stats
from trigenicinteractionpredictor_tpu_torch.ops.em import make_batch
from trigenicinteractionpredictor_tpu_torch.ops.scoring import serve_predict_interaction
from trigenicinteractionpredictor_tpu_torch.train.trainer import JsonlLogger, fit

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    from trigenicinteractionpredictor_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _case(n, g, k, r, s, seed, dev, pad_to=None):
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=r, seed=seed)
    if pad_to:
        ds = ds.pad_to(pad_to)
    return ds, init_state(g, k, r, samples=s, seed=seed + 1, device=dev)


@pytest.mark.parametrize(
    "k,r,s", [(2, 2, 4), (6, 3, 4), (10, 2, 50), (20, 2, 4), (20, 3, 2)]
)
def test_k1_matches_plain(dev, k, r, s):
    """Ragged rows padded with weight-0 rows; K across the kernel's range,
    up to its largest shared-memory plan (K = 20, R = 3).  p_hat cells hold
    up to ~N/K^3 of mass, so beside the absolute 1e-5 the p_hat check
    allows float32 rounding at that magnitude (rtol 1e-6)."""
    ds, st = _case(600, 70, k, r, s, seed=31, dev=dev, pad_to=1024)
    tb = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    launches = em_bdr.em_ensemble_stats.launches
    out = em_bdr.em_ensemble_stats(st.theta, st.p, tb)
    ref = em_bdr.em_ensemble_stats_reference(st.theta, st.p, tb)
    torch.cuda.synchronize()
    assert em_bdr.em_ensemble_stats.launches == launches + 1
    np.testing.assert_allclose(out.theta_hat.cpu(), ref.theta_hat.cpu(), atol=1e-4)
    np.testing.assert_allclose(out.p_hat.cpu(), ref.p_hat.cpu(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out.loglik.cpu(), ref.loglik.cpu(), rtol=1e-5)


def test_k1_refuses_what_it_does_not_take(dev):
    ds, st = _case(256, 20, 4, 2, 2, seed=1, dev=dev)
    tb = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    with pytest.raises(ValueError):
        em_bdr.em_ensemble_stats(st.theta, st.p, tb._replace(triplets=tb.triplets.long()))
    big = init_state(20, 21, 2, samples=1, seed=2, device=dev)
    with pytest.raises(ValueError):
        em_bdr.em_ensemble_stats(big.theta, big.p, tb)


@pytest.mark.parametrize(
    "k,r,s",
    [(21, 2, 1), (21, 3, 3), (25, 2, 3), (25, 3, 1), (33, 2, 3), (33, 3, 1),
     (50, 2, 3), (50, 3, 1), (64, 2, 1), (64, 3, 3)],
)
def test_k3_matches_plain(dev, k, r, s):
    """K3 across its range (K = 21..64, one and two indices per lane), R = 2
    and 3, S = 1 and 3, on ragged rows padded with weight-0 rows plus rows
    with an out-of-range gene id or rating, which the kernel must treat as
    inert: the plain version runs without them."""
    ds, st = _case(600, 70, k, r, s, seed=41, dev=dev, pad_to=1024)
    bad = np.array([[0, 70, 1], [-1, 2, 3], [4, 5, 2**31 - 1], [6, 7, 8]], np.int32)
    bad_r = np.array([1, 0, 1, r], np.int32)
    trips = np.concatenate([ds.triplets, bad])
    rats = np.concatenate([ds.ratings, bad_r])
    wts = np.concatenate([ds.weights, np.ones(4, np.float32)])
    tb = make_batch(trips, rats, wts, dev)
    launches = em_large_k.em_ensemble_stats.launches
    out = em_large_k.em_ensemble_stats(st.theta, st.p, tb)
    ref = em_large_k.em_ensemble_stats_reference(
        st.theta, st.p, make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    )
    torch.cuda.synchronize()
    assert em_large_k.em_ensemble_stats.launches == launches + 1
    np.testing.assert_allclose(out.theta_hat.cpu(), ref.theta_hat.cpu(), atol=1e-4)
    np.testing.assert_allclose(out.p_hat.cpu(), ref.p_hat.cpu(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out.loglik.cpu(), ref.loglik.cpu(), rtol=1e-5)


@pytest.mark.parametrize("k,g", [(56, 2000), (64, 4000)])
def test_k3_in_bdrg_regime_matches_plain(dev, k, g):
    """Where the reference runs its bdrg kernel (K = 56..64 at G =
    2000..4000), S = 10."""
    ds, st = _case(4096, g, k, 2, 10, seed=43, dev=dev)
    tb = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    out = em_large_k.em_ensemble_stats(st.theta, st.p, tb)
    ref = em_large_k.em_ensemble_stats_reference(st.theta, st.p, tb)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.theta_hat.cpu(), ref.theta_hat.cpu(), atol=1e-4)
    np.testing.assert_allclose(out.p_hat.cpu(), ref.p_hat.cpu(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out.loglik.cpu(), ref.loglik.cpu(), rtol=1e-5)


def test_k3_refuses_what_it_does_not_take(dev):
    ds, st = _case(256, 20, 25, 2, 2, seed=1, dev=dev)
    tb = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    with pytest.raises(ValueError):
        em_large_k.em_ensemble_stats(st.theta, st.p, tb._replace(ratings=tb.ratings.long()))
    for k in (20, 65):
        other = init_state(20, k, 2, samples=1, seed=2, device=dev)
        with pytest.raises(ValueError):
            em_large_k.em_ensemble_stats(other.theta, other.p, tb)


@pytest.mark.parametrize("g,n", [(40, 777), (60_000, 3000)])
def test_k2_matches_plain(dev, g, n):
    """A small G and a G far past the TPU kernel's one-hot cap, R = 3."""
    ds, st = _case(n, g, 6, 3, 4, seed=13, dev=dev)
    trips = torch.as_tensor(ds.triplets, dtype=torch.int32, device=dev)
    launches = score.ensemble_score.launches
    got = score.ensemble_score(st.theta, st.p, trips, 2)
    want = score.ensemble_score_reference(st.theta, st.p, trips, 2)
    torch.cuda.synchronize()
    assert score.ensemble_score.launches == launches + 1
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("k", [33, 50, 80])
def test_k2_past_k32_matches_plain(dev, k):
    """K2 stages p in chunks of k-slices past K = 32 (K = 50 is the sweep
    job's largest unit), and serve_predict_interaction takes it there."""
    ds, st = _case(3000, 60, k, 2, 3, seed=17, dev=dev)
    launches = score.ensemble_score.launches
    got = serve_predict_interaction(st, ds.triplets, block_rows=2048)
    assert score.ensemble_score.launches == launches + 2
    want = serve_predict_interaction(st, ds.triplets, fast=False)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-6)


def test_serve_goes_through_k2(dev):
    ds, st = _case(5000, 50, 5, 2, 3, seed=7, dev=dev)
    launches = score.ensemble_score.launches
    got = serve_predict_interaction(st, ds.triplets, block_rows=2048)
    assert score.ensemble_score.launches == launches + 3
    want = serve_predict_interaction(st, ds.triplets, fast=False)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-6)
    one = ModelState(st.theta[0], st.p[0])  # single state: the plain scorer
    assert serve_predict_interaction(one, ds.triplets).shape == (5000,)


def test_fit_through_k1_matches_plain_fit(dev):
    ds, _ = _case(4096, 200, 6, 2, 1, seed=3, dev=dev)
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, k=6, sweeps=20, samples=4, likelihood_freq=5, seed=5,
    ))
    quiet = JsonlLogger(None, echo=False)
    via_kernel = fit(cfg, ds, device=dev, logger=quiet)
    via_plain = fit(cfg, ds, device=dev, logger=quiet, stats_fn=plain_stats)
    assert via_kernel.dispatch["kernel"] == em_bdr.KERNEL_NAME
    assert via_plain.dispatch["kernel"] == "torch"
    np.testing.assert_allclose(via_kernel.final_loglik, via_plain.final_loglik, rtol=1e-4)
    np.testing.assert_allclose(via_kernel.ll_trace, via_plain.ll_trace, rtol=1e-4)
    trace = via_kernel.ll_trace
    assert np.all(trace[1:] >= trace[:-1] - 1e-5 * np.abs(trace[:-1]))


def test_fit_through_k3_matches_plain_fit(dev):
    ds, _ = _case(4096, 200, 25, 2, 1, seed=3, dev=dev)
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, k=25, sweeps=20, samples=3, likelihood_freq=5, seed=5,
    ))
    quiet = JsonlLogger(None, echo=False)
    via_kernel = fit(cfg, ds, device=dev, logger=quiet)
    via_plain = fit(cfg, ds, device=dev, logger=quiet, stats_fn=plain_stats)
    assert via_kernel.dispatch["kernel"] == em_large_k.KERNEL_NAME
    np.testing.assert_allclose(via_kernel.final_loglik, via_plain.final_loglik, rtol=1e-4)
    np.testing.assert_allclose(via_kernel.ll_trace, via_plain.ll_trace, rtol=1e-4)
    trace = via_kernel.ll_trace
    assert np.all(trace[1:] >= trace[:-1] - 1e-5 * np.abs(trace[:-1]))
