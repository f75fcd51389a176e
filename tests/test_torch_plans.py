"""K3's and K7's plans on the CPU: built with no value read back to the host,
equal to the plans built with ``torch.bincount``, and K3's built once per
fit.

K3 (``ops/em_large_k.py``) and K7 (``ops/em_hybrid.py``) read their rows in
rating order and sum their marginal streams along a gene-sorted plan of the
stream slots (``StreamPlan``: ``rating_order``, then
``ops/em_large_g.py::device_scatter_plan``).  Their offsets are searches of
the sorted keys, where a bincount on the card reads its keys' extremes back
to the host to size its output (a sync each).  Here the searches are held to
the bincount-and-cumsum offsets they replace (``_bincount_offsets``, the
previous code) on random rows, with empty ratings, ratings and ids out of
range and gene counts that are and are not a multiple of the block width;
the plan a classic fit's batch carries, built once per fit by the route's
record (``Sweep.batch``), is held to the plan a call builds, field by
field, and to the previous per-call plan; only K3's route gets one; and the plain scatter along the plan gives the
plain sweep's theta_hat.  Plans are permutations and integer offsets, so
those comparisons are exact; the scatter sums a gene's float32 marginals
(a few dozen here) in another order than the plain sweep, which moves them
by a few ulps: rtol 2e-6, atol 1e-6.
"""

import numpy as np
import pytest
import torch

from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu_torch.ops import (
    dispatch,
    em,
    em_bd,
    em_bdg,
    em_bdr,
    em_hybrid,
    em_large_g,
    em_large_k,
    em_rsorted,
)

torch.set_num_threads(2)


def _bincount_offsets(sorted_key, n_bins, width=1):
    """The offsets the sync-free plans replace: offsets[0] = 0 and
    offsets[q + 1] = the count of keys with key // width <= q, by
    ``torch.bincount`` and ``cumsum`` (as ``rating_order`` and
    ``device_scatter_plan`` built them before)."""
    off = torch.zeros(n_bins + 1, dtype=torch.int32)
    off[1:] = torch.cumsum(
        torch.bincount(sorted_key.long() // width, minlength=n_bins + 1)[:n_bins], 0)
    return off


def _old_rating_order(ratings, n_ratings):
    key = torch.where((ratings >= 0) & (ratings < n_ratings), ratings,
                      torch.full_like(ratings, n_ratings)).long()
    order = torch.argsort(key, stable=True).to(torch.int32)
    return order, _bincount_offsets(key[order.long()], n_ratings)


@pytest.mark.parametrize("n,r,lo,hi,seed", [
    (5000, 2, 0, 2, 0),      # every rating present
    (3000, 3, 0, 1, 1),      # ratings 1 and 2 empty
    (4000, 3, -2, 5, 2),     # ratings out of range at both ends
    (1, 2, 1, 2, 3),         # one row
    (0, 2, 0, 2, 4),         # no rows
    (777, 1, 0, 1, 5),       # one rating
])
def test_rating_order_offsets_equal_bincount_cumsum(n, r, lo, hi, seed):
    ratings = torch.as_tensor(
        np.random.default_rng(seed).integers(lo, hi, size=n).astype(np.int32))
    order, off = em_large_k.rating_order(ratings, r)
    want_order, want_off = _old_rating_order(ratings, r)
    assert order.dtype == off.dtype == torch.int32 and off.shape == (r + 1,)
    assert torch.equal(order, want_order)
    assert torch.equal(off, want_off)


@pytest.mark.parametrize("g,wb,bad", [
    (1000, 512, False),   # G not a multiple of wb: unknown ids fall in the last block
    (1024, 512, True),    # a multiple: they fall past it
    (1000, 512, True),
    (40, 16, True),
    (6000, 512, False),
])
def test_scatter_plan_offsets_equal_bincount_cumsum(g, wb, bad):
    rng = np.random.default_rng(g + wb)
    genes = torch.as_tensor(rng.integers(0, g, size=9000).astype(np.int32))
    if bad:
        genes[::11] = -1
        genes[5::13] = g + 3
    perm, lid, off = em_large_g.device_scatter_plan(genes, g, wb)
    key = torch.where((genes >= 0) & (genes < g), genes, torch.full_like(genes, g))
    key_sorted, want_perm = torch.sort(key, stable=True)
    q = -(-g // wb)
    assert off.dtype == torch.int32 and off.shape == (q + 1,)
    assert torch.equal(off, _bincount_offsets(key_sorted, q, wb))
    assert torch.equal(perm, want_perm.to(torch.int32))


def _k3_fit_batch(n, g, r, seed):
    ds, _, _ = sample_synthetic_dataset(n, g, 4, n_ratings=r, seed=seed)
    fn = dispatch.stats_fn_for(em_large_k.KERNEL_NAME, 25, r)
    return ds, fn.batch(ds, torch.device("cpu"))[0]


@pytest.mark.parametrize("n,g,r,seed", [(3000, 200, 2, 0), (2500, 1000, 3, 1), (700, 40, 1, 2)])
def test_the_once_per_fit_plan_is_the_per_call_plan(n, g, r, seed):
    """The K3 batch of a classic fit carries the plan a call would build on
    its own rows (the same stable sorts of the same keys), and that plan is
    the one the calls built before: the same rating order and offsets, the
    same slot order, local ids and block offsets."""
    ds, batch = _k3_fit_batch(n, g, r, seed)
    fit_plan = em_large_k.batch_stream_plan(batch, r, g)
    call_plan = em_large_k.stream_plan(batch.triplets, batch.ratings, r, g)
    for name in em_large_k.StreamPlan._fields:
        a, b = getattr(fit_plan, name), getattr(call_plan, name)
        assert a.dtype == torch.int32 and torch.equal(a, b), name
    order, off = _old_rating_order(batch.ratings, r)
    assert torch.equal(fit_plan.order, order) and torch.equal(fit_plan.off, off)
    genes = em_large_k.sorted_slot_genes(batch.triplets, batch.ratings, order, r)
    want = em_large_g.make_scatter_plan(genes.view(3, -1).t().numpy(), g)
    np.testing.assert_array_equal(fit_plan.perm.numpy(), want.perm)
    np.testing.assert_array_equal(fit_plan.lid.numpy(), want.lid)
    np.testing.assert_array_equal(fit_plan.offsets.numpy(), want.offsets)
    assert fit_plan.perm.shape == (3 * n,)


@pytest.mark.parametrize("route,k", [
    (em_large_k.KERNEL_NAME, 25),
    (em_bdr.KERNEL_NAME, 10),
    (em_hybrid.KERNEL_NAME, 25),
    (em_bdg.KERNEL_NAME, 10),
    (em_bd.KERNEL_NAME, 10),
    (em_large_g.KERNEL_NAME, 10),
    (dispatch.PLAIN_NAME, 10),
    (em_rsorted.KERNEL_NAME, 10),
])
def test_only_the_k3_route_gets_a_stream_plan(route, k):
    ds, _, _ = sample_synthetic_dataset(1500, 300, 4, n_ratings=2, seed=3)
    fn = (em_rsorted.stats_fn(64) if route == em_rsorted.KERNEL_NAME
          else dispatch.stats_fn_for(route, k, 2))
    batch, info = fn.batch(ds, torch.device("cpu"))
    fields = ("rating_order", "rating_offsets", "stream_perm", "stream_lid", "stream_offsets")
    got = [getattr(batch, f) is not None for f in fields]
    assert got == [route == em_large_k.KERNEL_NAME] * len(fields)
    if route == em_large_k.KERNEL_NAME:
        assert info == {"plan_rows": 3 * ds.n_rows}


@pytest.mark.parametrize("r,s", [(2, 3), (3, 1)])
def test_scatter_along_the_plan_is_the_sweeps_theta_hat(r, s):
    """The streams of the rows in the plan's rating order (the plain
    E-step's marginals), summed along the plan's gene-sorted slots, give
    the plain sweep's theta_hat: the plan is the one the kernel's streams
    need."""
    g, k = 150, 5
    ds, batch = _k3_fit_batch(2000, g, r, 6)
    plan = em_large_k.batch_stream_plan(batch, r, g)
    st = init_state(g, k, r, samples=s, seed=7, device="cpu")
    rows = plan.order.long()
    ordered = em.Batch(batch.triplets[rows], batch.ratings[rows], batch.weights[rows])
    streams, _, _ = em_bd.em_streams_reference(st.theta, st.p, ordered)
    got = em_bd.plan_scatter(streams, plan.perm, plan.lid, plan.offsets,
                             em_large_g.DEFAULT_WB, g, k)
    want = em.em_sufficient_stats(st.theta, st.p, batch).theta_hat
    torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("route", list(dispatch._ROUTES))
def test_each_routes_own_batch_gives_the_plain_sweeps_stats(route):
    """Every route of ``ops/dispatch.py``: its record's fit batch (with
    whatever plan the route builds), run through the route's stats in
    their plain CPU form, gives the plain sweep's stats on the rows as
    they came; and ``route_kernels`` is the record's ``kernels``.  The
    plans reorder the rows and scatter along gene blocks, which moves
    float32 sums by a few ulps: rtol 1e-5, atol 1e-6."""
    g, k, r, s = 1500, 4, 2, 2
    ds, _, _ = sample_synthetic_dataset(2000, g, k, n_ratings=r, seed=8)
    sweep = dispatch.stats_fn_for(route, k, r, row_chunk=512)
    assert sweep.kernel_name == route
    assert sweep.kernels == dispatch.route_kernels(route)
    batch = sweep.batch(ds, torch.device("cpu"))[0]
    st = init_state(g, k, r, samples=s, seed=9, device="cpu")
    got = sweep(st.theta, st.p, batch)
    want = dispatch.plain_stats(st.theta, st.p,
                                em.make_batch(ds.triplets, ds.ratings, ds.weights, "cpu"))
    for name, a, b in zip(em.SweepStats._fields, got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
