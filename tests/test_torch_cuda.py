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
from trigenicinteractionpredictor_tpu_torch.ops import (
    em_bd,
    em_bdg,
    em_bdr,
    em_hybrid,
    em_large_g,
    em_large_k,
    em_rsorted,
    score,
)
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


def _large_g_case(n, g, k, r, s, seed, dev, hub_pos=None):
    """Rows padded with weight-0 rows to a multiple of 512; with
    ``hub_pos``, gene 7 takes that position in 30% of the rows (a run far
    longer than plan_scatter's split limit)."""
    ds, st = _case(n, g, k, r, s, seed, dev, pad_to=-(-n // 512) * 512)
    trip = ds.triplets.copy()
    if hub_pos is not None:
        rng = np.random.default_rng(seed)
        trip[rng.random(len(trip)) < 0.3, hub_pos] = 7
    return trip, ds.ratings, ds.weights, st


def _assert_close_stats(out, ref):
    """As the K1 tests, with theta_hat also allowed float32 rounding at its
    magnitude (rtol 1e-6): a hub gene's row sums ~450 rows to ~200."""
    np.testing.assert_allclose(out.theta_hat.cpu(), ref.theta_hat.cpu(), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(out.p_hat.cpu(), ref.p_hat.cpu(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out.loglik.cpu(), ref.loglik.cpu(), rtol=1e-5)


@pytest.mark.parametrize(
    "k,r,s,g,hub_pos",
    [(4, 2, 1, 5000, 1), (10, 2, 10, 3000, 0), (10, 3, 10, 700, 2), (6, 2, 50, 2000, None),
     (20, 3, 2, 900, 1)],
)
def test_bd_plan_kernels_match_plain(dev, k, r, s, g, hub_pos):
    """K5a (em_streams) and K5b (plan_scatter) against their plain versions,
    alone and as the bd-plan / large-G sweep: S = 1, 10 and 50, R = 2 and
    3, weight-0 rows, empty gene blocks (G = 5000 over ~1500 rows) and a
    hub gene.  plan_scatter is deterministic: two launches agree bit for
    bit."""
    trip, rat, w, st = _large_g_case(1500, g, k, r, s, seed=51, dev=dev, hub_pos=hub_pos)
    plan = em_large_g.make_scatter_plan(trip, g, wb=64)
    tb = make_batch(trip, rat, w, dev, scatter=plan)
    n_streams, n_scatter = em_bd.em_streams.launches, em_bd.plan_scatter.launches
    streams, p_hat, ll = em_bd.em_streams(st.theta, st.p, tb)
    want_streams, want_p, want_ll = em_bd.em_streams_reference(st.theta, st.p, tb)
    torch.cuda.synchronize()
    assert em_bd.em_streams.launches == n_streams + 1
    np.testing.assert_allclose(streams.cpu(), want_streams.cpu(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p_hat.cpu(), want_p.cpu(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ll.cpu(), want_ll.cpu(), rtol=1e-5)
    args = (tb.scatter_perm, tb.scatter_lid, tb.scatter_offsets, 64, g, k)
    got = em_bd.plan_scatter(want_streams, *args)
    again = em_bd.plan_scatter(want_streams, *args)
    want = em_bd.plan_scatter_reference(want_streams, *args)
    torch.cuda.synchronize()
    assert em_bd.plan_scatter.launches == n_scatter + 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-5, atol=1e-5)
    for fn in (em_bd.bd_em_ensemble_stats, em_large_g.large_g_ensemble_stats):
        _assert_close_stats(fn(st.theta, st.p, tb, wb=64),
                            em_bd.bd_em_ensemble_stats_reference(st.theta, st.p, tb, wb=64))


def test_plan_scatter_splits_a_hub_run(dev):
    """One gene holds 33,000 of 60,000 slots (129 pieces of 256) beside a
    spread of others; the sum matches a float64 plain scatter."""
    rng = np.random.default_rng(3)
    g, k, s = 3000, 5, 4
    trip = rng.integers(0, g, size=(20_000, 3)).astype(np.int32)
    trip[:13_000, 0] = 1234
    trip[:, 1] = 1234
    plan = em_large_g.make_scatter_plan(trip, g, wb=512)
    streams = torch.as_tensor(rng.random((3, 20_000, s * k)), dtype=torch.float32,
                              device=dev)
    off = torch.as_tensor(plan.offsets, device=dev)
    perm = torch.as_tensor(plan.perm, device=dev)
    lid = torch.as_tensor(plan.lid, device=dev)
    got = em_bd.plan_scatter(streams, perm, lid, off, 512, g, k)
    want = em_bd.plan_scatter_reference(streams.double(), perm, lid, off, 512, g, k)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=2e-6, atol=1e-5)


@pytest.mark.parametrize(
    "k,r,s,g,hub_pos",
    [(4, 2, 1, 5000, 0), (10, 2, 10, 3000, 0), (10, 3, 10, 700, 1), (6, 2, 50, 2000, None),
     (20, 3, 2, 900, 0), (20, 2, 3, 6000, 2)],
)
def test_bdg_kernel_matches_plain(dev, k, r, s, g, hub_pos):
    """K4 against its plain version on g1-ordered rows, alone and with the
    2-position plan scatter: S = 1, 10 and 50, R = 2 and 3, weight-0 rows,
    empty gene blocks, a hub gene at position 1 (a g1 block split across
    many pieces) and elsewhere, and the gene-block width the plan gives at
    each (K, R) as well as a narrow one."""
    trip, rat, w, st = _large_g_case(1500, g, k, r, s, seed=53, dev=dev, hub_pos=hub_pos)
    for wb1 in {em_bdg.bdg_plan(k, r)[1], 32}:
        g1 = em_bdg.make_g1_plan(trip, g, wb1=wb1)
        t2, r2, w2 = em_bdg.apply_g1_order(g1, trip, rat, w)
        plan = em_large_g.make_scatter_plan(t2, g, wb=64, positions=(1, 2))
        tb = make_batch(t2, r2, w2, dev, scatter=plan, g1=g1)
        launches = em_bdg.bdg_estep.launches
        streams, th1, p_hat, ll = em_bdg.bdg_estep(st.theta, st.p, tb, wb1)
        want = em_bdg.bdg_estep_reference(st.theta, st.p, tb, wb1)
        torch.cuda.synchronize()
        assert em_bdg.bdg_estep.launches == launches + 1
        np.testing.assert_allclose(streams.cpu(), want[0].cpu(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(th1.cpu(), want[1].cpu(), rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(p_hat.cpu(), want[2].cpu(), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(ll.cpu(), want[3].cpu(), rtol=1e-5)
        _assert_close_stats(
            em_bdg.bdg_em_ensemble_stats(st.theta, st.p, tb, wb1=wb1, wb=64),
            em_bdg.bdg_em_ensemble_stats_reference(st.theta, st.p, tb, wb1=wb1, wb=64),
        )


def test_large_g_kernels_refuse_what_they_do_not_take(dev):
    trip, rat, w, st = _large_g_case(600, 800, 4, 2, 2, seed=1, dev=dev)
    plain = make_batch(trip, rat, w, dev)
    for fn in (em_bd.bd_em_ensemble_stats, em_large_g.large_g_ensemble_stats,
               em_bdg.bdg_em_ensemble_stats):
        with pytest.raises(ValueError):
            fn(st.theta, st.p, plain)
    plan = em_large_g.make_scatter_plan(trip, 800, wb=64)
    tb = make_batch(trip, rat, w, dev, scatter=plan)
    with pytest.raises(ValueError):  # plan of another block width
        em_bd.plan_scatter(torch.zeros((3, len(trip), 8), device=dev), tb.scatter_perm,
                           tb.scatter_lid, tb.scatter_offsets, 128, 800, 4)
    big = init_state(800, 21, 2, samples=2, seed=2, device=dev)
    with pytest.raises(ValueError):
        em_bd.em_streams(big.theta, big.p, tb)


@pytest.mark.parametrize("route", ["cuda-em-bdg", "cuda-em-bd-plan", "cuda-em-large-g"])
def test_fit_through_large_g_routes_matches_plain_fit(dev, route):
    """G = 6000 through each plan route (the trainer builds and attaches
    the plans) against the plain fit, from the same seeded init."""
    from trigenicinteractionpredictor_tpu_torch.ops import dispatch

    s = 1 if route == "cuda-em-large-g" else 3
    ds, _ = _case(4096, 6000, 4, 2, 1, seed=3, dev=dev)
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, k=4, sweeps=12, samples=s, likelihood_freq=4, seed=5,
    ))
    quiet = JsonlLogger(None, echo=False)
    via_kernel = fit(cfg, ds, device=dev, logger=quiet,
                     stats_fn=dispatch.stats_fn_for(route, 4, 2))
    via_plain = fit(cfg, ds, device=dev, logger=quiet, stats_fn=plain_stats)
    assert via_kernel.dispatch["kernel"] == route
    np.testing.assert_allclose(via_kernel.final_loglik, via_plain.final_loglik, rtol=1e-4)
    np.testing.assert_allclose(via_kernel.ll_trace, via_plain.ll_trace, rtol=1e-4)


@pytest.mark.parametrize(
    "k,r,s",
    [(21, 2, 1), (21, 3, 10), (25, 2, 2), (25, 3, 10), (40, 2, 2), (40, 3, 1),
     (50, 2, 1), (50, 3, 2), (64, 2, 10), (64, 3, 1)],
)
def test_k7_matches_plain(dev, k, r, s):
    """K7 across K = 21..64, R = 2 and 3, S = 1, 2 and 10, on a B that is no
    tile multiple, with weight-0 rows and rows with an out-of-range gene id
    or rating, which the kernel must treat as inert: the plain version runs
    without them.  The kernel alone on the streams, and through the route's
    stats function (gather + kernel)."""
    ds, st = _case(601, 70, k, r, s, seed=61, dev=dev)
    w = ds.weights.copy()
    w[::9] = 0.0
    bad = np.array([[0, 70, 1], [-1, 2, 3], [4, 5, 2**31 - 1], [6, 7, 8]], np.int32)
    trips = np.concatenate([ds.triplets, bad])
    rats = np.concatenate([ds.ratings, np.array([1, 0, 1, r], np.int32)])
    wts = np.concatenate([w, np.ones(4, np.float32)])
    tb = make_batch(trips, rats, wts, dev)
    clean = make_batch(ds.triplets, ds.ratings, w, dev)
    streams = em_hybrid.gather_rows(st.theta, tb.triplets)
    launches = em_hybrid.hybrid_stats.launches
    out = em_hybrid.hybrid_stats(*streams, tb.triplets, tb.ratings, tb.weights, st.p, 70)
    via_route = em_hybrid.em_ensemble_stats(st.theta, st.p, tb)
    ref = em_hybrid.em_ensemble_stats_reference(
        *em_hybrid.gather_rows(st.theta, clean.triplets), clean.triplets, clean.ratings,
        clean.weights, st.p, 70)
    torch.cuda.synchronize()
    assert em_hybrid.hybrid_stats.launches == launches + 2
    for got in (out, via_route):
        np.testing.assert_allclose(got.theta_hat.cpu(), ref.theta_hat.cpu(), atol=1e-4)
        np.testing.assert_allclose(got.p_hat.cpu(), ref.p_hat.cpu(), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got.loglik.cpu(), ref.loglik.cpu(), rtol=1e-5)


def test_k7_refuses_what_it_does_not_take(dev):
    ds, st = _case(256, 20, 25, 2, 2, seed=1, dev=dev)
    tb = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    streams = em_hybrid.gather_rows(st.theta, tb.triplets)
    with pytest.raises(ValueError):  # int64 ids
        em_hybrid.hybrid_stats(*streams, tb.triplets.long(), tb.ratings, tb.weights, st.p, 20)
    with pytest.raises(ValueError):  # streams of another restart count
        em_hybrid.hybrid_stats(*(x[:, :25] for x in streams), tb.triplets, tb.ratings,
                               tb.weights, st.p, 20)
    for k in (20, 65):
        other = init_state(20, k, 2, samples=1, seed=2, device=dev)
        with pytest.raises(ValueError):
            em_hybrid.em_ensemble_stats(other.theta, other.p, tb)


@pytest.mark.parametrize("route,k", [("cuda-em-sweep", 10), ("cuda-em-sweep-large-k", 25),
                                     ("cuda-em-hybrid", 25)])
def test_stepwise_fit_through_each_route_matches_plain(dev, route, k):
    """Stepwise EM (2 groups a epoch, prefetch on) through each kernel
    route against the plain stepwise fit from the same init and shuffles;
    at G = 6000, K = 25, S = 2 the route is K7."""
    from trigenicinteractionpredictor_tpu_torch.ops import dispatch

    ds, _ = _case(20_000, 6000, 5, 2, 1, seed=3, dev=dev)
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, k=k, sweeps=3, samples=2, likelihood_freq=1, seed=5, minibatch=4096,
        stream_groups=2,
    ))
    quiet = JsonlLogger(None, echo=False)
    if route == "cuda-em-hybrid":
        assert fit(cfg.replace(train=dataclasses.replace(cfg.train, sweeps=1)), ds,
                   device=dev, logger=quiet).dispatch["kernel"] == route
    via_kernel = fit(cfg, ds, device=dev, logger=quiet,
                     stats_fn=dispatch.stats_fn_for(route, k, 2))
    via_plain = fit(cfg, ds, device=dev, logger=quiet, stats_fn=plain_stats)
    assert via_kernel.dispatch["kernel"] == route
    np.testing.assert_allclose(via_kernel.final_loglik, via_plain.final_loglik, rtol=1e-4)
    np.testing.assert_allclose(via_kernel.ll_trace, via_plain.ll_trace, rtol=1e-4)


def _rsorted_case(k, r, s, tile_b, dev, seed=71):
    """1500 rows with every row of rating 1 moved to rating 0 (class 1 is
    empty and gets its one pad tile), a tenth of the rows weight 0, sorted
    into plan tiles of ``tile_b``; the per-row ratings handed to K9 are
    scrambled, since it must read the tile table only."""
    ds, st = _case(1500, 70, k, r, s, seed=seed, dev=dev)
    rat = np.where(ds.ratings == 1, 0, ds.ratings).astype(np.int32)
    w = ds.weights.copy()
    w[::10] = 0.0
    plan = em_rsorted.rating_sort_pad(rat, r, tile=tile_b)
    trip, rs, ws = em_rsorted.apply_rating_sort(plan, ds.triplets, rat, w)
    tb = make_batch(trip, rs, ws, dev, tile_rating=plan.tile_r)
    scrambled = tb._replace(ratings=torch.flip(tb.ratings, (0,)))
    return st, tb, scrambled


@pytest.mark.parametrize(
    "k,r,s,tile_b",
    [(3, 2, 1, 64), (3, 3, 3, 512), (10, 2, 10, 512), (10, 3, 3, 64), (20, 2, 3, 64),
     (20, 3, 10, 512), (em_rsorted.MAX_K, 2, 1, 64), (em_rsorted.MAX_K, 3, 3, 512)],
)
def test_k9_matches_plain(dev, k, r, s, tile_b):
    """K9 across K = 3..28 (its top), R = 2 and 3, S = 1, 3 and 10, plan
    tiles of 64 and 512 rows, with an empty rating class, weight-0 rows,
    block runs that cross rating classes, and scrambled per-row ratings."""
    st, tb, scrambled = _rsorted_case(k, r, s, tile_b, dev)
    launches = em_rsorted.rsorted_em_ensemble_stats.launches
    out = em_rsorted.rsorted_em_ensemble_stats(st.theta, st.p, scrambled, tile_b)
    ref = em_rsorted.rsorted_em_ensemble_stats_reference(st.theta, st.p, tb, tile_b)
    torch.cuda.synchronize()
    assert em_rsorted.rsorted_em_ensemble_stats.launches == launches + 1
    np.testing.assert_allclose(out.theta_hat.cpu(), ref.theta_hat.cpu(), atol=1e-4)
    np.testing.assert_allclose(out.p_hat.cpu(), ref.p_hat.cpu(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out.loglik.cpu(), ref.loglik.cpu(), rtol=1e-5)


def test_k9_refuses_what_it_does_not_take(dev):
    st, tb, _ = _rsorted_case(4, 2, 2, 64, dev)
    with pytest.raises(ValueError):  # no tile table
        em_rsorted.rsorted_em_ensemble_stats(st.theta, st.p, tb._replace(tile_rating=None), 64)
    with pytest.raises(ValueError):  # a table of another tile size
        em_rsorted.rsorted_em_ensemble_stats(st.theta, st.p, tb, 128)
    with pytest.raises(ValueError):  # no kernel tile divides a plan tile of 4
        em_rsorted.rsorted_em_ensemble_stats(
            st.theta, st.p, tb._replace(tile_rating=tb.tile_rating.repeat_interleave(16)), 4)
    big = init_state(70, em_rsorted.MAX_K + 1, 2, samples=1, seed=2, device=dev)
    with pytest.raises(ValueError):
        em_rsorted.rsorted_em_ensemble_stats(big.theta, big.p, tb, 64)


@pytest.mark.parametrize("minibatch", [0, 1024])
def test_fit_through_k9_matches_plain_fit(dev, minibatch):
    """Classic and stepwise EM through K9 (the trainer sorts the split or
    every minibatch) against the plain fit from the same init."""
    ds, _ = _case(4096, 200, 6, 2, 1, seed=3, dev=dev)
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, k=6, sweeps=12 if not minibatch else 3, samples=3, likelihood_freq=4
        if not minibatch else 1, seed=5, minibatch=minibatch, stream_groups=2,
    ))
    quiet = JsonlLogger(None, echo=False)
    launches = em_rsorted.rsorted_em_ensemble_stats.launches
    via_kernel = fit(cfg, ds, device=dev, logger=quiet, stats_fn=em_rsorted.stats_fn(64))
    via_plain = fit(cfg, ds, device=dev, logger=quiet, stats_fn=plain_stats)
    assert via_kernel.dispatch == dict(via_plain.dispatch, kernel=em_rsorted.KERNEL_NAME,
                                       tile_b=64)
    assert em_rsorted.rsorted_em_ensemble_stats.launches - launches == (
        12 if not minibatch else 3 * 4)
    np.testing.assert_allclose(via_kernel.final_loglik, via_plain.final_loglik, rtol=1e-4)
    np.testing.assert_allclose(via_kernel.ll_trace, via_plain.ll_trace, rtol=1e-4)


def test_integrity_sentinel_passes_on_the_card(dev, tmp_path, monkeypatch):
    """Every probe passes on the card, the verdict lands in the disk cache,
    and a second call launches nothing."""
    from trigenicinteractionpredictor_tpu_torch.utils import integrity

    monkeypatch.setattr(integrity, "CACHE_PATH", str(tmp_path / "verdicts.json"))
    integrity.clear_cache()
    assert integrity.check_em_integrity(dev, 3)
    assert all(p.ok for p in integrity.last_probes), integrity.last_probes
    launches = em_bdr.em_ensemble_stats.launches
    assert integrity.check_em_integrity(dev, 3)
    integrity.clear_cache()
    assert integrity.check_em_integrity(dev, 3)  # from the disk cache
    assert em_bdr.em_ensemble_stats.launches == launches
