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


@pytest.mark.parametrize("n,g,k,r", [(256, 24, 33, 3), (256, 1000, 65, 2), (300, 1000, 72, 2)])
def test_k3_plain_matches_single_restart_kernel(n, g, k, r):
    """The reference's ``pallas-onehot-single`` route: K = 64, here at K =
    33, and K = 65 and 72 at G = 1000, the last K its dispatch gives the
    kernel (the second on a ragged row count padded with weight-0 rows)."""
    from trigenicinteractionpredictor_tpu.ops.dispatch import _pallas_single_fn

    ds, st, jb, tb = _case(n, g, k, r, 1, seed=6, pad_to=128)
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
    """K3's plan exists for every K in 21..72 at R = 1, 2 and 3 within one
    block's shared memory and thread limits, and is None outside;
    ``sweep_plan`` is the one statement of the range (K7's wrapper and the
    route read it)."""
    assert (em_large_k.MIN_K, em_large_k.MAX_K) == (21, 72)
    for k in range(21, 73):
        for r in (1, 2, 3):
            plan = em_large_k.sweep_plan(k, r)
            assert plan is not None, (k, r)
            assert max(plan.estep_smem, plan.cross_smem) <= 232_448 - 1024
            # pass 1: 16 row groups x K/4 column groups, two blocks an SM
            assert plan.estep_threads == 16 * plan.kc // 4 <= 288
            assert 2 * (plan.estep_smem + 1024) <= 233_472
            # pass 2: one k, 4 l and 8 m a thread, whole k's a block
            per_k = -(-k // 4) * -(-k // 8)
            assert plan.cross_threads == plan.nk * per_k <= 384
            assert plan.cross_threads >= 128
            assert plan.vec in (1, 2, 4) and k % plan.vec == 0
    # pass 1 at K = 72: two stages of packed p, the theta tiles of 64 rows,
    # the A1 partial sums, weights, scales, gene ids and rows
    assert em_large_k.sweep_plan(72, 2).estep_smem == 4 * (
        2 * 72 * 72 + 3 * 72 * 68 + 2 * 18 * 64 + 2 * 64 + 4 * 64)
    for k in (0, 10, 20, 73, 80):
        assert em_large_k.sweep_plan(k, 2) is None
    assert em_large_k.sweep_plan(50, 4) is None


@pytest.mark.parametrize("k", [21, 25, 31, 33, 50, 63, 64, 65, 72])
@pytest.mark.parametrize("r", [2, 3])
def test_k3_plan_mirrors_the_smem_layout(k, r):
    """The plan's bytes are the source's carve, written out: pass 1 (kRows1
    = 64 rows, row stride 68) holds two stages of K x KC packed p, three
    [KC][68] theta tiles, two [KC/4][64] partial sums, weights, scales and
    four int vectors of 64; pass 2 (kRows2 = 64 rows a stage) two buffers
    of th1, th2 [64][LP] and th3 [64][MP], three stages of int4 row info
    and of scales.  Neither grows with R: every block reads one rating."""
    plan = em_large_k.sweep_plan(k, r)
    kc = 4 * -(-k // 4)
    lp, mp = 4 * -(-k // 4), 8 * -(-k // 8)
    assert plan.kc == kc
    assert plan.estep_smem == 4 * (2 * k * kc + 3 * kc * 68 + 2 * (kc // 4) * 64
                                   + 2 * 64 + 4 * 64)
    assert plan.cross_smem == 4 * (2 * 64 * (2 * lp + mp) + 3 * 64 * 4 + 3 * 64)
    assert plan.vec == (4 if k % 4 == 0 else 2 if k % 2 == 0 else 1)
    assert plan == em_large_k.sweep_plan(k, 1)


@pytest.mark.parametrize("n,r,seed", [(1, 2, 0), (257, 2, 1), (1000, 3, 2), (64, 3, 3),
                                      (500, 1, 4)])
def test_rating_order_is_a_stable_permutation(n, r, seed):
    """``rating_order`` sorts rows by rating, stably, with rows of an
    out-of-range rating (negative or >= R) last, and ``off`` bounds each
    rating's run."""
    rng = np.random.default_rng(seed)
    ratings = rng.integers(-1, r + 2, size=n).astype(np.int32)
    order, off = em_large_k.rating_order(torch.as_tensor(ratings), r)
    order, off = order.numpy(), off.numpy()
    assert order.dtype == np.int32 and off.dtype == np.int32
    assert sorted(order.tolist()) == list(range(n))
    key = np.where((ratings >= 0) & (ratings < r), ratings, r)
    np.testing.assert_array_equal(order, np.argsort(key, kind="stable"))
    assert off[0] == 0 and off.shape == (r + 1,)
    for q in range(r):
        run = order[off[q]:off[q + 1]]
        assert (ratings[run] == q).all() and (np.diff(run) > 0).all()
    assert (key[order[off[r]:]] == r).all()


@pytest.mark.parametrize("k,r,s", [(21, 3, 2), (25, 2, 3), (33, 2, 1)])
def test_plain_sweep_of_rating_ordered_rows(k, r, s):
    """The plain sweep of a batch reordered by ``rating_order`` equals the
    plain sweep of the batch: the same float32 sums in another order (rows
    of ~300, so rtol 1e-5 with atol 1e-6 on theta_hat and p_hat, loglik
    rtol 1e-5)."""
    ds, st, _, tb = _case(300, 40, k, r, s, seed=17)
    order, _ = em_large_k.rating_order(tb.ratings, r)
    idx = order.long()
    ordered = tem.Batch(tb.triplets[idx], tb.ratings[idx], tb.weights[idx])
    a = em_large_k.em_ensemble_stats_reference(st.theta, st.p, tb)
    b = em_large_k.em_ensemble_stats_reference(st.theta, st.p, ordered)
    np.testing.assert_allclose(b.theta_hat.numpy(), a.theta_hat.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.p_hat.numpy(), a.p_hat.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.loglik.numpy(), a.loglik.numpy(), rtol=1e-5)


@pytest.mark.parametrize("static_rows", [True, False])
def test_hybrid_band_ends_at_k64(static_rows):
    """HYBRID_BAND has no entry past K = 64, so raising K3's range to 72
    moves no shape to K7: K = 65..72 is K3 at every S and G."""
    assert max(em_large_k.MIN_K + len(band) - 1 for band in dispatch.HYBRID_BAND.values()) == 64
    for s in (1, 2, 10):
        for g in (0, 500, 1000, 2500, 4000, 8000, 100_000):
            for k in range(65, 73):
                assert not dispatch.in_hybrid_band(k, s, g, static_rows)
                assert dispatch.route("cuda", 3, k, 2, s, n_genes=g,
                                      static_rows=static_rows) == em_large_k.KERNEL_NAME
            assert dispatch.route("cuda", 3, 73, 2, s, n_genes=g,
                                  static_rows=static_rows) == "torch"


@pytest.mark.parametrize(
    "device_type,arity,k,r,expected",
    [
        ("cuda", 3, 5, 2, em_bdr.KERNEL_NAME),
        ("cuda", 3, 20, 3, em_bdr.KERNEL_NAME),
        ("cuda", 3, 21, 2, em_large_k.KERNEL_NAME),
        ("cuda", 3, 50, 2, em_large_k.KERNEL_NAME),
        ("cuda", 3, 64, 3, em_large_k.KERNEL_NAME),
        ("cuda", 3, 65, 2, em_large_k.KERNEL_NAME),
        ("cuda", 3, 72, 3, em_large_k.KERNEL_NAME),
        ("cuda", 3, 73, 2, "torch"),
        ("cuda", 3, 80, 2, "torch"),
        ("cpu", 3, 72, 2, "torch"),
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
