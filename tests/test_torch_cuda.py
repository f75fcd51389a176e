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


def _k1_rows(n, g, k, r, s, seed, dev, hub):
    """n rows padded with weight-0 rows to n + 101 (a ragged last tile),
    5% of the rows inside weighted 0 too, ratings drawn per row (the
    warps of a tile mix ratings); with ``hub``, gene g // 3 at position 1
    in 40% of the rows."""
    ds, st = _case(n, g, k, r, s, seed, dev, pad_to=n + 101)
    rng = np.random.default_rng(seed)
    trip, w = ds.triplets.copy(), ds.weights.copy()
    w[rng.random(len(w)) < 0.05] = 0.0
    if hub:
        trip[rng.random(len(trip)) < 0.4, 0] = g // 3
    return make_batch(trip, ds.ratings, w, dev), st


@pytest.mark.parametrize("k,r", [(1, 1), (1, 3), (3, 2), (7, 3), (9, 2), (10, 1), (10, 2),
                                 (10, 3), (13, 3), (17, 1), (20, 2), (20, 3)])
@pytest.mark.parametrize("hub", [False, True])
def test_k1_row_pass_matches_plain(dev, k, r, hub):
    """K1's register-resident E-step, exact at K = 10 and padded to the
    next multiple of 4 elsewhere, against the plain sweep in float64: K =
    1, odd K, 10 and 20, R = 1..3, on a ragged last tile, weight-0 rows and
    (hub) a gene in 40% of the rows; the private theta_hat form and the
    streams form (K5a), at the tolerances of test_k1_matches_plain
    (theta_hat also rtol 1e-6 at a hub, as _assert_close_stats).  In
    float64, since at these sizes the float32 plain sweep's own rounding
    passes rtol 1e-6 (a p_hat cell sums ~100 rows at K = 3, the hub ~1100);
    at R = 1 with p from 0.2 to 1, since a fitted p is 1 there, every D is
    1 and L is 0 up to rounding."""
    tb, st = _k1_rows(2900, 400, k, r, 3, seed=61 + k, dev=dev, hub=hub)
    p = st.p
    if r == 1:
        gen = torch.Generator(device=dev).manual_seed(k)
        p = 0.2 + 0.8 * torch.rand(p.shape, device=dev, generator=gen)
    launches = em_bdr.em_ensemble_stats.launches
    out = em_bdr.em_ensemble_stats(st.theta, p, tb)
    streams, p_hat, ll = em_bd.em_streams(st.theta, p, tb)
    args = (st.theta.double(), p.double(), tb._replace(weights=tb.weights.double()))
    ref = em_bdr.em_ensemble_stats_reference(*args)
    want_streams, want_p, want_ll = em_bd.em_streams_reference(*args)
    torch.cuda.synchronize()
    assert em_bdr.em_ensemble_stats.launches == launches + 1
    _assert_close_stats(out, type(ref)(*(x.float() for x in ref)))
    np.testing.assert_allclose(streams.cpu(), want_streams.float().cpu(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p_hat.cpu(), want_p.float().cpu(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ll.cpu(), want_ll.float().cpu(), rtol=1e-5)


# K1's and K5a's output digests (SHA-256 of the outputs' bytes in order, first
# 16 hex digits) on _k1_rows(2850, ...), whose last tile holds 7 rows, from the
# kernel before its E-step moved into the header K4 shares; taken on the card
# named.
K1_BITS_CARD = ("NVIDIA H100 80GB HBM3", 132)
K1_BITS = {
    (3, 2, False): ("d3f643d03daa89ef", "fd560b7974a8cdd3"),
    (10, 2, False): ("3df30405e70aaef6", "6e49b212ddd93068"),
    (10, 2, True): ("0888a6430cd2a02d", "5157a757de6c8f6a"),
    (13, 3, False): ("033abcaf661b8258", "9d874ae8f535ab79"),
    (20, 3, True): ("6aa5ea0825b5370e", "9ca3995d6edda2fb"),
}


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("k,r,hub", sorted(K1_BITS))
def test_k1_shared_row_pass_keeps_the_bits(dev, k, r, hub):
    """K1's register-resident E-step, shared with K4 (which alone lets a
    warp with no row of a short tile skip the pass), gives K1 (private
    theta_hat) and K5a (streams) the bits recorded before the sharing, on
    a short last tile.  The grid, and with it the order of every sum,
    follows the card's SM count, so the record is checked on the card it
    was taken on."""
    props = torch.cuda.get_device_properties(dev)
    if (props.name, props.multi_processor_count) != K1_BITS_CARD:
        pytest.skip(f"bits recorded on {K1_BITS_CARD}, not {props.name}")
    tb, st = _k1_rows(2850, 400, k, r, 3, seed=61 + k, dev=dev, hub=hub)
    assert (tb.triplets.shape[0] % em_bdr.sweep_plan(k, r)[0]) in range(1, 57)
    got = (_digest(em_bdr.em_ensemble_stats(st.theta, st.p, tb)),
           _digest(em_bd.em_streams(st.theta, st.p, tb)))
    assert got == K1_BITS[(k, r, hub)]


@pytest.mark.parametrize("k,r", [(1, 1), (4, 2), (7, 3), (10, 2), (10, 3), (13, 2), (16, 1),
                                 (17, 3), (20, 2), (20, 3)])
def test_k1_grid_counts_the_blocks_an_sm_holds(dev, k, r):
    """The blocks an SM holds of (K, R)'s kernel instance at its plan's
    shared memory (the CUDA occupancy calculator) are the ones K1's grid
    plans waves of (ops/em_bdr.py sweep_resident): four at K = 10, R = 2."""
    from trigenicinteractionpredictor_tpu_torch.ops import _build

    smem = em_bdr.sweep_plan(k, r)[1]
    held = _build.library().tip_em_sweep_occupancy(k, r, smem)
    assert held == em_bdr.sweep_resident(k, r, smem)


@pytest.mark.parametrize(
    "k,r,s",
    [(21, 2, 1), (21, 3, 3), (25, 2, 3), (25, 3, 1), (33, 2, 3), (33, 3, 1),
     (50, 2, 3), (50, 3, 1), (64, 2, 1), (64, 3, 3), (65, 2, 1), (65, 3, 10),
     (72, 2, 10), (72, 3, 1)],
)
def test_k3_matches_plain(dev, k, r, s):
    """K3 across its range (K = 21..72: one, two and three indices per lane),
    R = 2 and 3, S = 1, 3 and 10, on ragged rows padded with weight-0 rows plus rows
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
    for k in (20, 73):
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


@pytest.mark.parametrize("k,g,n,r", [(10, 1000, 3001, 2), (33, 70, 777, 3), (50, 60, 2000, 2),
                                      (80, 60, 515, 2), (115, 40, 130, 2),
                                      (10, 60_000, 3000, 2), (1, 30, 100, 2), (17, 50, 640, 2)])
def test_k2_matches_plain_across_k(dev, k, g, n, r):
    """K2 across its block shapes (4 x 2 warps at K = 10, 8 x 1 at K = 50, 6
    and 5 warps at K = 115 and 17), one and many stages of m, ragged row
    counts, and a G far past the TPU kernel's cap, within 1e-5 absolute of
    the plain scorer; two launches give the same bits."""
    ds, st = _case(n, g, k, r, 3, seed=19, dev=dev)
    trips = torch.as_tensor(ds.triplets, dtype=torch.int32, device=dev)
    launches = score.ensemble_score.launches
    got = score.ensemble_score(st.theta, st.p, trips, r - 1)
    again = score.ensemble_score(st.theta, st.p, trips, r - 1)
    want = score.ensemble_score_reference(st.theta, st.p, trips, r - 1)
    torch.cuda.synchronize()
    assert score.ensemble_score.launches == launches + 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=1e-5)


def test_k2_refuses_what_it_does_not_take(dev):
    ds, st = _case(256, 20, 4, 2, 2, seed=1, dev=dev)
    trips = torch.as_tensor(ds.triplets, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # int64 ids
        score.ensemble_score(st.theta, st.p, trips.long())
    with pytest.raises(ValueError):  # no such rating
        score.ensemble_score(st.theta, st.p, trips, 2)
    big = init_state(20, 137, 2, samples=1, seed=2, device=dev)
    with pytest.raises(ValueError):  # past the plan
        score.ensemble_score(big.theta, big.p, trips)
    bad = trips.clone()
    bad[5, 1] = 20  # a gene id out of range scores NaN, the other rows as before
    got = score.ensemble_score(st.theta, st.p, bad)
    want = score.ensemble_score_reference(st.theta, st.p, trips)
    torch.cuda.synchronize()
    assert torch.isnan(got[5]) and int(torch.isnan(got).sum()) == 1
    keep = torch.arange(256, device=dev) != 5
    np.testing.assert_allclose(got[keep].cpu(), want[keep].cpu(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [33, 50, 80])
def test_k2_past_k32_matches_plain(dev, k):
    """K2 streams the packed slice of p in stages past K = 32 as below it
    (K = 50 is the sweep job's largest unit), and serve_predict_interaction
    takes it there."""
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


FEED_BLOCK = 2048
# CUDA runtime calls that wait for the device (benchmark/spans.py's SYNCS).
HOST_SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy"}


@pytest.mark.parametrize("fast,dtype", [(True, np.int32), (False, np.int32), (True, np.int64)])
@pytest.mark.parametrize("n", [1500, 3 * FEED_BLOCK, 3 * FEED_BLOCK + 777, 12 * FEED_BLOCK + 5])
def test_pinned_feed_matches_the_scorer_block_by_block(dev, n, fast, dtype):
    """The pinned feed gives, bit for bit, K2 (``fast``) or the plain scorer
    applied to each block of device rows, for less than a block, whole blocks,
    a ragged last block and chunks at their cap, from int32 or int64 ids; K2
    launches once a block and every block goes through the feed."""
    ds, st = _case(n, 60, 10, 2, 3, seed=23, dev=dev)
    rows = ds.triplets.astype(dtype)
    blocks = -(-n // FEED_BLOCK)
    launches = score.ensemble_score.launches
    staged = serve_predict_interaction.staged_blocks
    got = serve_predict_interaction(st, rows, block_rows=FEED_BLOCK, fast=fast)
    assert serve_predict_interaction.staged_blocks == staged + blocks
    assert score.ensemble_score.launches == launches + (blocks if fast else 0)
    scorer = score.ensemble_score if fast else score.ensemble_score_reference
    trips = torch.as_tensor(ds.triplets, dtype=torch.int32, device=dev)
    want = torch.cat([scorer(st.theta, st.p, trips[i : i + FEED_BLOCK])
                      for i in range(0, n, FEED_BLOCK)]).cpu().numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)


def test_pinned_feed_from_two_threads(dev):
    """Two threads scoring at once each get their own rows' scores: the feed's
    pinned and device buffers are per call, its streams ordered by events."""
    import threading

    ds, st = _case(6 * FEED_BLOCK + 11, 60, 10, 2, 3, seed=37, dev=dev)
    rows = [ds.triplets, ds.triplets[::-1]]
    want = [serve_predict_interaction(st, r, block_rows=FEED_BLOCK) for r in rows]
    got, errors = [[], []], []

    def work(j):
        try:
            for _ in range(8):
                got[j].append(serve_predict_interaction(st, rows[j], block_rows=FEED_BLOCK))
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(j,)) for j in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for j in range(2):
        assert len(got[j]) == 8
        for g in got[j]:
            np.testing.assert_array_equal(g, want[j])


def test_pinned_feed_refuses_a_bad_id_before_any_launch(dev):
    ds, st = _case(3 * FEED_BLOCK + 5, 60, 10, 2, 3, seed=29, dev=dev)
    rows = ds.triplets.copy()
    rows[-1, 1] = 60  # in the last block
    launches = score.ensemble_score.launches
    staged = serve_predict_interaction.staged_blocks
    with pytest.raises(ValueError, match="gene ids"):
        serve_predict_interaction(st, rows, block_rows=FEED_BLOCK)
    torch.cuda.synchronize()
    assert score.ensemble_score.launches == launches
    assert serve_predict_interaction.staged_blocks == staged


def test_pinned_feed_makes_one_sync_and_no_pageable_copy(dev):
    """A warm call, under the profiler: its copies are all pinned and it
    waits for the device once, at the end (the pageable feed synced once a
    block)."""
    from torch.profiler import ProfilerActivity, profile

    ds, st = _case(8 * FEED_BLOCK + 100, 60, 10, 2, 3, seed=31, dev=dev)
    serve_predict_interaction(st, ds.triplets, block_rows=FEED_BLOCK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve_predict_interaction(st, ds.triplets, block_rows=FEED_BLOCK)
    names = {e.key: e.count for e in prof.key_averages()}
    assert any("Memcpy HtoD" in k for k in names), sorted(names)
    assert not [k for k in names if "Pageable" in k], sorted(names)
    # Within the call's span: the profiler syncs the device itself on exit.
    host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    call = [e.time_range for e in host if e.name == "serve"]
    assert len(call) == 1, call
    inside = [e.name for e in host if call[0].start <= e.time_range.start <= call[0].end]
    assert sum(name in HOST_SYNCS for name in inside) <= 1, inside


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


@pytest.mark.parametrize("s,k,out_given", [(1, 10, False), (10, 10, True), (3, 7, False),
                                           (3, 6, True), (50, 10, False), (40, 4, True)])
def test_plan_scatter_widths(dev, s, k, out_given):
    """K5b at S*K = 10 (K6's stage, 512-slot pieces), 100 (the table's
    shape, 16-byte copies), 21 (4-byte copies), 18 (8-byte copies), 500 and
    160 (several column tiles), with a hub gene that spans many pieces, a
    ragged last piece, empty gene blocks, and ``out`` zeroed or holding
    another position's share: within float32 rounding of a float64 plain
    scatter, and the same bits from two launches."""
    rng = np.random.default_rng(s * 100 + k)
    g, n = 3000, 4001
    trip = rng.integers(0, g, size=(n, 3)).astype(np.int32)
    trip[: n // 2, 2] = 77
    plan = em_large_g.make_scatter_plan(trip, g, wb=256)
    streams = torch.as_tensor(rng.random((3, n, s * k)), dtype=torch.float32, device=dev)
    args = tuple(torch.as_tensor(x, device=dev) for x in (plan.perm, plan.lid, plan.offsets))
    args += (256, g, k)
    base = (torch.as_tensor(rng.random((s, g, k)), dtype=torch.float32, device=dev)
            if out_given else None)
    clone = lambda t: None if t is None else t.clone()  # noqa: E731
    launches = em_bd.plan_scatter.launches
    got = em_bd.plan_scatter(streams, *args, out=clone(base))
    again = em_bd.plan_scatter(streams, *args, out=clone(base))
    want = em_bd.plan_scatter_reference(
        streams.double(), *args, out=None if base is None else base.double())
    torch.cuda.synchronize()
    assert em_bd.plan_scatter.launches == launches + 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=2e-6, atol=1e-5)
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-4


def test_plan_scatter_splits_a_hub_run(dev):
    """One gene holds 33,000 of 60,000 slots (129 pieces of 256 at S*K = 20)
    beside a spread of others; the sum matches a float64 plain scatter."""
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


def _k4_rows(g, k, r, wb1, seed, dev):
    """30,000 rows in g1 order whose gene blocks of wb1 genes hold 1 row
    (blocks 0..9), 65 rows (blocks 10..19: a full tile and a 1-row tail
    tile where a piece holds the block), 4,000 rows (block 20, run over
    many pieces), and the rest over the genes past block 20; ratings drawn
    per row, 5% of the rows weighted 0."""
    rng = np.random.default_rng(seed)
    g1 = [q * wb1 + q % wb1 for q in range(10)]
    g1 += [q * wb1 + int(x) for q in range(10, 20) for x in rng.integers(0, wb1, 65)]
    g1 += list(20 * wb1 + rng.integers(0, wb1, 4000))
    g1 += list(rng.integers(21 * wb1, g, 30_000 - len(g1)))
    trip = rng.integers(0, g, size=(30_000, 3)).astype(np.int32)
    trip[:, 0] = np.asarray(g1, np.int32)
    rat = rng.integers(0, r, size=30_000).astype(np.int32)
    w = np.where(rng.random(30_000) < 0.05, 0.0, 1.0).astype(np.float32)
    plan = em_bdg.make_g1_plan(trip, g, wb1=wb1)
    return make_batch(*em_bdg.apply_g1_order(plan, trip, rat, w), dev, g1=plan)


@pytest.mark.parametrize("k,r", [(1, 1), (1, 3), (3, 2), (7, 3), (10, 1), (10, 2), (10, 3),
                                 (13, 2), (20, 2), (20, 3)])
def test_k4_row_pass_on_short_tiles_matches_plain(dev, k, r):
    """K4 on K1's register-resident E-step and carve against its plain
    version in float64: K = 1, odd K, 10 and 20, R = 1..3, at the plan's
    gene block and at 32, on gene blocks of 1 row, of 65 rows (a 1-row
    tail tile), a hub gene block split over many pieces (S = 10: pieces of
    ~5 tiles) and weight-0 rows, at test_bdg_kernel_matches_plain's
    tolerances; and the same bits twice.  In float64 and at R = 1 with p
    from 0.2 to 1 as test_k1_row_pass_matches_plain, for its reasons."""
    g, s = 40_000, 10
    st = init_state(g, k, r, samples=s, seed=71 + k, device=dev)
    p = st.p
    if r == 1:
        gen = torch.Generator(device=dev).manual_seed(k)
        p = 0.2 + 0.8 * torch.rand(p.shape, device=dev, generator=gen)
    for wb1 in {em_bdg.bdg_plan(k, r)[1], 32}:
        tb = _k4_rows(g, k, r, wb1, seed=73 + k, dev=dev)
        launches = em_bdg.bdg_estep.launches
        got = em_bdg.bdg_estep(st.theta, p, tb, wb1)
        again = em_bdg.bdg_estep(st.theta, p, tb, wb1)
        want = em_bdg.bdg_estep_reference(
            st.theta.double(), p.double(), tb._replace(weights=tb.weights.double()), wb1)
        torch.cuda.synchronize()
        assert em_bdg.bdg_estep.launches == launches + 2
        for x, y in zip(got, again):
            assert torch.equal(x, y)
        want = [x.float().cpu() for x in want]
        np.testing.assert_allclose(got[0].cpu(), want[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[1].cpu(), want[1], rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(got[2].cpu(), want[2], rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got[3].cpu(), want[3], rtol=1e-5)


def _k4_crossing_rows(case, dev):
    """(K, R, S, G, batch in g1 order) of a named case for K4's tiles
    that run on past a gene block's end (gene blocks of wb1 = 64)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    k, r, s = (6, 3, 4) if case == "k6_r3" else (10, 2, 10)
    # The cell's ~67 rows a gene block at a quarter of its rows; G far
    # above B (~4 rows a block: tiles cut by a second block's end); a hub
    # gene block over ~25 pieces of 320 rows; rows only in every third
    # gene block; B no multiple of the tile; K = 6, R = 3 at ~20 rows a block.
    g, n = {"cell_density": (25_000, 26_214), "g_far_above_b": (100_000, 6_000),
            "hub_over_pieces": (40_000, 30_000), "empty_blocks": (60_000, 20_000),
            "b_not_tile_multiple": (12_000, 10_007), "k6_r3": (20_000, 6_251)}[case]
    trip = rng.integers(0, g, size=(n, 3)).astype(np.int32)
    if case == "hub_over_pieces":
        trip[:8_000, 0] = 64 * 300 + rng.integers(0, 64, 8_000)
    if case == "empty_blocks":
        trip[:, 0] = 64 * (3 * rng.integers(0, g // 192, n)) + rng.integers(0, 64, n)
    rat = rng.integers(0, r, size=n).astype(np.int32)
    w = np.where(rng.random(n) < 0.05, 0.0, 1.0).astype(np.float32)
    plan = em_bdg.make_g1_plan(trip, g, wb1=64)
    return k, r, s, g, make_batch(*em_bdg.apply_g1_order(plan, trip, rat, w), dev, g1=plan)


@pytest.mark.parametrize("case", ["cell_density", "g_far_above_b", "hub_over_pieces",
                                  "empty_blocks", "b_not_tile_multiple", "k6_r3"])
def test_k4_tiles_across_gene_blocks_match_plain(dev, case):
    """K4's tiles hold rows of up to two gene blocks, cut only at a piece's
    end or at the second block's end: against its plain version in float64
    at test_bdg_kernel_matches_plain's tolerances, and the same bits twice,
    on rows where tiles cross gene blocks' ends (and, where blocks hold
    fewer rows than a tile, are cut by a second block's end), a hub gene
    block over many pieces (heads, tails and the fixup), empty gene
    blocks, a B that is no multiple of the tile, and K = 6, R = 3."""
    k, r, s, g, tb = _k4_crossing_rows(case, dev)
    st = init_state(g, k, r, samples=s, seed=5, device=dev)
    tile = em_bdg.bdg_plan(k, r)[0]
    n = tb.triplets.shape[0]
    census = em_bdg.bdg_tile_census(tb.g1_offsets.cpu().numpy(), n,
                                    em_bdg.bdg_pieces(n, s, tile, em_bdr.sm_count(dev))[0], tile)
    assert census.crossing > census.tiles // 2
    if case == "g_far_above_b":
        assert census.cut > census.tiles // 2
    got = em_bdg.bdg_estep(st.theta, st.p, tb, 64)
    again = em_bdg.bdg_estep(st.theta, st.p, tb, 64)
    want = em_bdg.bdg_estep_reference(
        st.theta.double(), st.p.double(), tb._replace(weights=tb.weights.double()), 64)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    want = [x.float().cpu() for x in want]
    np.testing.assert_allclose(got[0].cpu(), want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].cpu(), want[1], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got[2].cpu(), want[2], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[3].cpu(), want[3], rtol=1e-5)


@pytest.mark.parametrize("k,r", [(1, 1), (4, 2), (7, 3), (10, 2), (10, 3), (13, 2), (16, 1),
                                 (17, 3), (20, 2), (20, 3)])
def test_k4_plan_counts_the_blocks_an_sm_holds(dev, k, r):
    """The blocks an SM holds of K4's instance for (K, R) at its plan's
    shared memory (the CUDA occupancy calculator) are the ones the plan
    counts (ops/em_bdg.py _resident, bdg_resident): four at K = 10, R = 2."""
    from trigenicinteractionpredictor_tpu_torch.ops import _build

    tile, wb1 = em_bdg.bdg_plan(k, r)
    smem = em_bdg._smem_bytes(k, r, tile, wb1)
    held = _build.library().tip_em_bdg_occupancy(k, r, smem)
    assert held == em_bdg._resident(k, r, smem) == em_bdg.bdg_resident(k, r)


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
    for k in (20, 73):
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


LAYOUTS = ("one_rating", "absent", "short", "cross", "hub")


def _layout_rows(layout, n, g, k, r, seed):
    """Rows that stress the kernels' rating order and atomics:
    ``one_rating`` every row of rating R - 1; ``absent`` (R = 3) no row of
    rating 1; ``short`` 5 rows of rating 1 (a segment shorter than a tile);
    ``cross`` 70 rows of rating 1 (a segment crossing a 64-row tile);
    ``hub`` gene 7 at position 1 in 80% of the rows and at position 3 in
    30% (the theta_hat atomics pile onto one gene row).  n is no multiple
    of any row tile."""
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=r, seed=seed)
    trip, rat, w = ds.triplets.copy(), ds.ratings.copy(), ds.weights.copy()
    rng = np.random.default_rng(seed)
    if layout == "one_rating":
        rat[:] = r - 1
    elif layout == "absent":
        rat = np.where(rat == 1, 0, rat).astype(np.int32)
    elif layout in ("short", "cross"):
        rat[:] = 0
        rat[rng.choice(n, 5 if layout == "short" else 70, replace=False)] = 1
    elif layout == "hub":
        trip[rng.random(n) < 0.8, 0] = 7
        trip[rng.random(n) < 0.3, 2] = 7
    return trip, rat, w


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("k", [1, 10])
def test_k1_on_rating_layouts(dev, layout, k):
    """K1 (K = 1 included) on one rating only, R = 3 with one rating absent,
    short and tile-crossing rating segments, and a hub gene, on B = 1001 (300
    for the hub) rows; at the file's tolerances (a hub's theta_hat also
    rtol 1e-6, as _assert_close_stats)."""
    r = 3 if layout == "absent" else 2
    trip, rat, w = _layout_rows(layout, 300 if layout == "hub" else 1001, 70, k, r, seed=81)
    st = init_state(70, k, r, samples=3, seed=82, device=dev)
    tb = make_batch(trip, rat, w, dev)
    launches = em_bdr.em_ensemble_stats.launches
    out = em_bdr.em_ensemble_stats(st.theta, st.p, tb)
    ref = em_bdr.em_ensemble_stats_reference(st.theta, st.p, tb)
    torch.cuda.synchronize()
    assert em_bdr.em_ensemble_stats.launches == launches + 1
    _assert_close_stats(out, ref)


@pytest.mark.parametrize(
    "k,layout",
    [(21, "one_rating"), (31, "absent"), (33, "short"), (63, "cross"), (65, "hub"),
     (72, "one_rating"), (72, "absent"), (50, "cross"), (21, "hub"), (33, "cross")],
)
def test_k3_and_k7_on_rating_layouts(dev, k, layout):
    """K3 and K7 (its streams) at K = 21, 31, 33, 63, 65 and 72 (odd K, and
    each side of a change in column groups and gather width) on the rating
    layouts of the K1 test, against the plain sweep."""
    r = 3 if layout == "absent" else 2
    trip, rat, w = _layout_rows(layout, 300 if layout == "hub" else 1001, 70, k, r, seed=83)
    st = init_state(70, k, r, samples=2, seed=84, device=dev)
    tb = make_batch(trip, rat, w, dev)
    ref = em_large_k.em_ensemble_stats_reference(st.theta, st.p, tb)
    k3 = em_large_k.em_ensemble_stats.launches
    k7 = em_hybrid.hybrid_stats.launches
    out3 = em_large_k.em_ensemble_stats(st.theta, st.p, tb)
    out7 = em_hybrid.hybrid_stats(*em_hybrid.gather_rows(st.theta, tb.triplets), tb.triplets,
                                  tb.ratings, tb.weights, st.p, 70)
    torch.cuda.synchronize()
    assert em_large_k.em_ensemble_stats.launches == k3 + 1
    assert em_hybrid.hybrid_stats.launches == k7 + 1
    _assert_close_stats(out3, ref)
    _assert_close_stats(out7, ref)


@pytest.mark.parametrize("layout", ["one_rating", "absent", "cross", "hub"])
def test_k4_and_k5a_on_rating_layouts(dev, layout):
    """K4 (g1-ordered rows) and K5a on the rating layouts, K = 10, S = 3,
    G = 3000, against their plain versions."""
    r = 3 if layout == "absent" else 2
    g, k = 3000, 10
    trip, rat, w = _layout_rows(layout, 300 if layout == "hub" else 1001, g, k, r, seed=85)
    st = init_state(g, k, r, samples=3, seed=86, device=dev)
    got = em_bd.em_streams(st.theta, st.p, make_batch(trip, rat, w, dev))
    want = em_bd.em_streams_reference(st.theta, st.p, make_batch(trip, rat, w, dev))
    wb1 = em_bdg.bdg_plan(k, r)[1]
    g1 = em_bdg.make_g1_plan(trip, g, wb1=wb1)
    tb = make_batch(*em_bdg.apply_g1_order(g1, trip, rat, w), dev, g1=g1)
    got4 = em_bdg.bdg_estep(st.theta, st.p, tb, wb1)
    want4 = em_bdg.bdg_estep_reference(st.theta, st.p, tb, wb1)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu(), want[0].cpu(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got4[0].cpu(), want4[0].cpu(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got4[1].cpu(), want4[1].cpu(), rtol=1e-6, atol=1e-4)
    for a, b in ((got, want), (got4, want4)):
        np.testing.assert_allclose(a[-2].cpu(), b[-2].cpu(), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(a[-1].cpu(), b[-1].cpu(), rtol=1e-5)


BETA = 0.3  # a DAEM inverse temperature early in the ramp


def _assert_powered_stats(out, ref, f64):
    """A sweep on (theta^beta, p^beta): off the simplex, D_beta grows toward
    K^3, but theta_hat and p_hat stay responsibility sums of the same
    magnitude, so the file's tolerances hold against the plain version;
    against a float64 run of the plain version the max abs error is at most
    1e-4 of max |plain| (chip_smoke.py's STATS_REL_TOL), and loglik rtol
    1e-5."""
    _assert_close_stats(out, ref)
    for name in ("theta_hat", "p_hat"):
        a, b, c = (getattr(x, name).double().cpu() for x in (out, ref, f64))
        assert float((a - c).abs().max()) <= 1e-4 * float(b.abs().max()), name
    np.testing.assert_allclose(out.loglik.double().cpu(), f64.loglik.cpu(), rtol=1e-5)


@pytest.mark.parametrize(
    "kernel,k,r,s",
    [("K1", 10, 2, 4), ("K1", 20, 3, 2), ("K3", 25, 2, 3), ("K3", 50, 2, 2), ("K3", 72, 3, 1),
     ("K4", 10, 2, 3), ("K5a", 10, 3, 3), ("K7", 25, 2, 2), ("K7", 64, 3, 1), ("K9", 10, 2, 3),
     ("K9", em_rsorted.MAX_K, 2, 1)],
)
def test_sweep_kernels_on_powered_states(dev, kernel, k, r, s):
    """Every sweep kernel the annealed fit runs, on (theta^0.3, p^0.3),
    against its plain version and float64."""
    g = 3000 if kernel in ("K4", "K5a") else 70
    trip, rat, w, st = _large_g_case(1500, g, k, r, s, seed=91, dev=dev)
    th, p = st.theta ** BETA, st.p ** BETA
    assert float(th.sum(-1).max()) > 1.5  # off the simplex
    if kernel == "K1":
        tb = make_batch(trip, rat, w, dev)
        run = lambda t_, p_: em_bdr.em_ensemble_stats(t_, p_, tb)  # noqa: E731
        plain = lambda t_, p_: em_bdr.em_ensemble_stats_reference(t_, p_, tb)  # noqa: E731
    elif kernel == "K3":
        tb = make_batch(trip, rat, w, dev)
        run = lambda t_, p_: em_large_k.em_ensemble_stats(t_, p_, tb)  # noqa: E731
        plain = lambda t_, p_: em_large_k.em_ensemble_stats_reference(  # noqa: E731
            t_, p_, tb, row_chunk=512)
    elif kernel == "K4":
        wb1 = em_bdg.bdg_plan(k, r)[1]
        g1 = em_bdg.make_g1_plan(trip, g, wb1=wb1)
        t2, r2, w2 = em_bdg.apply_g1_order(g1, trip, rat, w)
        plan = em_large_g.make_scatter_plan(t2, g, wb=64, positions=(1, 2))
        tb = make_batch(t2, r2, w2, dev, scatter=plan, g1=g1)
        run = lambda t_, p_: em_bdg.bdg_em_ensemble_stats(t_, p_, tb, wb1=wb1, wb=64)  # noqa
        plain = lambda t_, p_: em_bdg.bdg_em_ensemble_stats_reference(  # noqa: E731
            t_, p_, tb, wb1=wb1, wb=64)
    elif kernel == "K5a":
        tb = make_batch(trip, rat, w, dev, scatter=em_large_g.make_scatter_plan(trip, g, wb=64))
        run = lambda t_, p_: em_bd.bd_em_ensemble_stats(t_, p_, tb, wb=64)  # noqa: E731
        plain = lambda t_, p_: em_bd.bd_em_ensemble_stats_reference(t_, p_, tb, wb=64)  # noqa
    elif kernel == "K7":
        tb = make_batch(trip, rat, w, dev)
        run = lambda t_, p_: em_hybrid.hybrid_stats(  # noqa: E731
            *em_hybrid.gather_rows(t_, tb.triplets), tb.triplets, tb.ratings, tb.weights, p_, g)
        plain = lambda t_, p_: em_hybrid.em_ensemble_stats_reference(  # noqa: E731
            *em_hybrid.gather_rows(t_, tb.triplets), tb.triplets, tb.ratings, tb.weights, p_, g)
    else:
        tile_b = 64 if k == 10 else 512
        plan = em_rsorted.rating_sort_pad(rat, r, tile=tile_b)
        tb = make_batch(*em_rsorted.apply_rating_sort(plan, trip, rat, w), dev,
                        tile_rating=plan.tile_r)
        run = lambda t_, p_: em_rsorted.rsorted_em_ensemble_stats(t_, p_, tb, tile_b)  # noqa
        plain = lambda t_, p_: em_rsorted.rsorted_em_ensemble_stats_reference(  # noqa: E731
            t_, p_, tb, tile_b)
    out = run(th, p)
    ref = plain(th, p)
    f64 = plain(th.double(), p.double())
    torch.cuda.synchronize()
    _assert_powered_stats(out, ref, f64)


@pytest.mark.parametrize("k,knobs", [
    (6, dict(anneal_beta0=0.3, anneal_sweeps=10)),
    (25, dict(anneal_beta0=0.3, anneal_sweeps=10)),
    (6, dict(anneal_beta0=0.3, anneal_sweeps=10, init_method="spectral", smem_rounds=1,
             smem_sweeps=5, refine_rounds=1, refine_sweeps=5)),
])
def test_fit_with_quality_knobs_matches_plain_fit(dev, k, knobs):
    """An annealed fit (and one with all four knobs) through K1 / K3
    against the same fit through the plain sweep: final L and trace rtol
    1e-4, the same rounds' decisions."""
    ds, _ = _case(4096, 200, 6, 2, 1, seed=3, dev=dev)
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, k=k, sweeps=20, samples=3, likelihood_freq=5, seed=5, **knobs))

    class Events:
        def __init__(self):
            self.events = []

        def log(self, event, **fields):
            self.events.append((event, fields))

    ev_k, ev_p = Events(), Events()
    via_kernel = fit(cfg, ds, device=dev, logger=ev_k)
    via_plain = fit(cfg, ds, device=dev, logger=ev_p, stats_fn=plain_stats)
    want = em_bdr.KERNEL_NAME if k <= 20 else em_large_k.KERNEL_NAME
    assert via_kernel.dispatch["kernel"] == want
    assert via_kernel.sweeps_run == via_plain.sweeps_run
    # An accepted round patches the worst lane (argmin), which may fall among
    # lanes equal to float32 rounding: compare the exchangeable lanes as a set.
    np.testing.assert_allclose(np.sort(via_kernel.final_loglik),
                               np.sort(via_plain.final_loglik), rtol=1e-4)
    np.testing.assert_allclose(via_kernel.ll_trace, via_plain.ll_trace, rtol=1e-4)
    rounds = [[(f["to_ll"], f.get("accepted_move")) for e, f in ev.events
               if e in ("smem_done", "refine_done")] for ev in (ev_k, ev_p)]
    np.testing.assert_allclose([ll for ll, _ in rounds[0]], [ll for ll, _ in rounds[1]],
                               rtol=1e-4)
    assert [m for _, m in rounds[0]] == [m for _, m in rounds[1]]
    assert any(e == "anneal" for e, _ in ev_k.events)


CARD_RANK = r"""
import sys
from datetime import timedelta
import numpy as np
import torch
from trigenicinteractionpredictor_tpu_torch.config import Config, MeshConfig, TrainConfig
from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu_torch.ops import em_bdr
from trigenicinteractionpredictor_tpu_torch.parallel.distributed import (
    maybe_initialize, rank_device, shutdown)
from trigenicinteractionpredictor_tpu_torch.train.trainer import JsonlLogger, fit

topo = maybe_initialize("cuda:0", "gloo", timeout=timedelta(seconds=120))
dev = rank_device("cuda:0")
ds, _, _ = sample_synthetic_dataset(4096, 200, 10, n_ratings=2, seed=4)
cfg = Config(train=TrainConfig(k=10, sweeps=20, samples=4, likelihood_freq=5, seed=5),
             mesh=MeshConfig(data=2))
em_bdr.em_ensemble_stats.launches = 0
r = fit(cfg, ds, device=dev, logger=JsonlLogger(None, echo=False))
np.savez(sys.argv[1] + f".{topo.process_index}.npz", ll=r.final_loglik, trace=r.ll_trace,
         sweeps=r.sweeps_run, launches=em_bdr.em_ensemble_stats.launches,
         kernel=r.dispatch["kernel"])
shutdown()
"""


def test_two_gloo_ranks_on_the_card_match_one_process(dev, tmp_path):
    """Two ranks share the card under gloo (data 2), each running K1 on its
    half of the rows: the same sweeps and L (rtol 1e-5) as the one-process
    fit on the card."""
    import torch_ranks

    script = tmp_path / "rank.py"
    script.write_text(CARD_RANK)
    torch_ranks.wait(torch_ranks.start_world(str(script), 2, [tmp_path / "out"]))
    ds, _, _ = sample_synthetic_dataset(4096, 200, 10, n_ratings=2, seed=4)
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, k=10, sweeps=20, samples=4,
                                                likelihood_freq=5, seed=5))
    one = fit(cfg, ds, device=dev, logger=JsonlLogger(None, echo=False))
    for rank in (0, 1):
        z = np.load(tmp_path / f"out.{rank}.npz")
        assert str(z["kernel"]) == em_bdr.KERNEL_NAME and int(z["launches"]) == 20
        assert int(z["sweeps"]) == one.sweeps_run
        np.testing.assert_allclose(z["ll"], one.final_loglik, rtol=1e-5)
        np.testing.assert_allclose(z["trace"], one.ll_trace, rtol=1e-5)


def _records():
    import json
    import os

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "perf_records.json")) as fh:
        return json.load(fh)


def test_bench_engine_launches_its_route(dev):
    """``bench.measure_engine`` at the headline shape (20 sweeps a timed
    run): K1 and the block sum of its partials at S = 1 and S = 10, each
    launched once a sweep of the first step and the three timed runs,
    nothing else launched."""
    from trigenicinteractionpredictor_tpu_torch import bench
    from trigenicinteractionpredictor_tpu_torch.ops import block_sum

    before = em_bdr.em_ensemble_stats.launches
    runs = bench.measure_engine(bench.parse_args(["--sweeps", "20"]))
    assert [r.samples for r in runs] == [1, bench.S]
    for r in runs:
        assert r.route == em_bdr.KERNEL_NAME and r.sweeps == 20
        assert r.launches == {em_bdr.KERNEL_NAME: 10 + 3 * 20,
                              block_sum.KERNEL_NAME: 10 + 3 * 20}
        assert r.updates_per_sec > 0 and np.isfinite(r.ll_best)
    assert em_bdr.em_ensemble_stats.launches == before + 2 * (10 + 3 * 20)


@pytest.mark.parametrize("name", ["default", "recoverable"])
def test_quality_bands_on_the_card(dev, name):
    """``bench_quality`` at a quality record's args lands in the record's
    bands: |auc_final - record| <= auc_band, sweeps_to_converged <= record
    + sweeps_slack, and (recoverable) auc_final >= auc_chance_floor; K1 ran
    every sweep and K2 every AUC check."""
    from trigenicinteractionpredictor_tpu_torch import bench_quality

    rec = _records()["quality"][name]
    args = bench_quality.parse_args(rec["args"] + ["--device", "cuda"])
    sweeps = args.max_sweeps // args.freq * args.freq
    k1, k2 = em_bdr.em_ensemble_stats.launches, score.ensemble_score.launches
    res = bench_quality.measure(args)
    assert abs(res["auc_final"] - rec["auc_final"]) <= rec["auc_band"], res
    assert res["sweeps_to_converged"] <= rec["sweeps_to_converged"] + rec["sweeps_slack"], res
    assert res["auc_final"] >= rec.get("auc_chance_floor", 0.0), res
    assert em_bdr.em_ensemble_stats.launches - k1 == args.freq + sweeps
    assert score.ensemble_score.launches - k2 == 2 + sweeps // args.freq


@pytest.mark.parametrize("route,k,g,s", [
    ("cuda-em-sweep", 10, 1000, 10), ("cuda-em-sweep", 20, 300, 2),
    ("cuda-em-sweep", 13, 2000, 3),
    ("cuda-em-sweep-large-k", 25, 1000, 3), ("cuda-em-sweep-large-k", 72, 500, 2),
    ("cuda-em-hybrid", 25, 3000, 2), ("cuda-em-bdg", 10, 50_000, 4),
    ("cuda-em-bd-plan", 10, 50_000, 4), ("cuda-em-large-g", 10, 50_000, 1),
    ("cuda-em-rsorted", 10, 1000, 4), ("cuda-em-rsorted", 28, 300, 2), ("torch", 10, 1000, 4),
])
@pytest.mark.parametrize("hub", [False, True])
def test_sweep_routes_give_the_same_bits_twice(dev, route, k, g, s, hub):
    """Every sweep route (and K9, and the plain sweep on CUDA) sums in an
    order fixed by its rows and plan: two runs on the route's fit batch
    give equal theta_hat, p_hat and loglik, with a hub gene in 40% of the
    rows at position 1 too (a gene block K4 splits over pieces)."""
    from trigenicinteractionpredictor_tpu_torch.ops import dispatch

    ds, st = _case(20_000, g, k, 2, s, seed=31, dev=dev)
    if hub:
        trips = ds.triplets.copy()
        trips[np.random.default_rng(0).random(len(trips)) < 0.4, 0] = g // 3
        ds = dataclasses.replace(ds, triplets=trips)
    fn = (em_rsorted.stats_fn(512) if route == em_rsorted.KERNEL_NAME
          else dispatch.stats_fn_for(route, k, 2, row_chunk=8192))
    batch = fn.batch(ds, dev)[0]
    a, b = fn(st.theta, st.p, batch), fn(st.theta, st.p, batch)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.isfinite(x).all() and torch.equal(x, y)


def test_k1_streams_form_gives_the_same_bits_and_the_stats(dev, monkeypatch):
    """Past its partials budget K1 writes marginal streams for the plan
    scatter: the same stats as its private form, the same bits twice."""
    ds, st = _case(20_000, 2000, 10, 2, 4, seed=33, dev=dev)
    batch = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    private = em_bdr.em_ensemble_stats(st.theta, st.p, batch)
    monkeypatch.setattr(em_bdr, "THETA_PART_BYTES", 0)
    scatters = em_bd.plan_scatter.launches
    a = em_bdr.em_ensemble_stats(st.theta, st.p, batch)
    b = em_bdr.em_ensemble_stats(st.theta, st.p, batch)
    torch.cuda.synchronize()
    assert em_bd.plan_scatter.launches == scatters + 2
    for x, y, z in zip(a, b, private):
        assert torch.equal(x, y)
        np.testing.assert_allclose(x.cpu(), z.cpu(), rtol=1e-5, atol=1e-5)


def _hub_pairs(g, n_pairs, shared):
    """Query pairs (two genes each) whose genes ``bucket_of`` sends to one
    warp (``shared``) or to two."""
    buckets = (np.arange(g, dtype=np.int64) * em_bdr.BUCKET_HASH & 0xFFFFFFFF) >> (
        32 - em_bdr.BUCKET_BITS)
    pairs, free = [], list(range(g))
    while len(pairs) < n_pairs:
        a = free.pop(0)
        b = next(x for x in free if (buckets[x] == buckets[a]) == shared)
        free.remove(b)
        pairs.append((a, b))
    return pairs, free


@pytest.mark.parametrize("shared", [False, True])
def test_k1_on_hub_tiles_matches_plain_and_keeps_its_bits(dev, shared):
    """Data S1's layout (each query pair crossed to every array gene, rows
    in query order): every 64-row tile holds its pair's two genes 64 times
    each, two hub keys in one warp where ``shared``.  K = 10, R = 2, S = 2
    against the plain sweep in float64 at test_k1_row_pass_matches_plain's
    tolerances, and the same bits from two launches."""
    g, k, r, s, n_array = 400, 10, 2, 2, 150
    pairs, free = _hub_pairs(g, 3, shared)
    array = np.asarray(free[:n_array])
    trip = np.asarray([(a, b, c) for a, b in pairs for c in array], np.int32)
    rng = np.random.default_rng(5)
    rat = (rng.random(len(trip)) < 0.1).astype(np.int32)
    tb = make_batch(trip, rat, np.ones(len(trip), np.float32), dev)
    census = em_bdr.key_census(trip, np.ones(len(trip)), s, k, r,
                               em_bdr.sm_count(dev))
    assert census.chain_max >= 60
    st = init_state(g, k, r, samples=s, seed=9, device=dev)
    out = em_bdr.em_ensemble_stats(st.theta, st.p, tb)
    again = em_bdr.em_ensemble_stats(st.theta, st.p, tb)
    ref = em_bdr.em_ensemble_stats_reference(
        st.theta.double(), st.p.double(), tb._replace(weights=tb.weights.double()))
    torch.cuda.synchronize()
    _assert_close_stats(out, type(ref)(*(x.float() for x in ref)))
    for x, y in zip(out, again):
        assert torch.equal(x, y)
