"""PyTorch port vs the JAX reference at large G, on the CPU: the host plans
(ops/em_large_g.py make_scatter_plan, ops/em_bdg.py make_g1_plan /
apply_g1_order) against the reference's; the plain versions of the
large-G kernels (K4 bdg, K5 bd-plan, K6 large-G) against the reference's
Pallas kernels in interpret mode, in their single-call and restart-grouped
forms; the route map and the ``--backend`` repair; and fits at G = 6000
through each plan route against the reference's ``fit(backend="pallas")``.

The same inputs, made with numpy from a seed, go through both packages.
Tolerances are the reference's own (tests/test_pallas_large.py:58-67):
theta_hat rtol 2e-5 / atol 1e-6, p_hat rtol 2e-5 / atol 1e-7, loglik rtol
2e-5; a fit's final L rtol 1e-5 (its :122-124).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trigenicinteractionpredictor_tpu.config import Config, EngineConfig, TrainConfig
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState as JState
from trigenicinteractionpredictor_tpu.ops import em as jem
from trigenicinteractionpredictor_tpu.ops import pallas_em_bdg as jbdg
from trigenicinteractionpredictor_tpu.ops import pallas_em_large as jlarge
from trigenicinteractionpredictor_tpu.train.trainer import fit as jfit
from trigenicinteractionpredictor_tpu.utils.logging import JsonlLogger
from trigenicinteractionpredictor_tpu_torch.cli import main as cli_main
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu_torch.ops import (
    dispatch,
    em_bd,
    em_bdg,
    em_bdr,
    em_large_g,
    em_large_k,
)
from trigenicinteractionpredictor_tpu_torch.ops import em as tem
from trigenicinteractionpredictor_tpu_torch.train import trainer
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit

torch.set_num_threads(2)

THETA_TOL = dict(rtol=2e-5, atol=1e-6)  # reference tests/test_pallas_large.py:58-61
P_TOL = dict(rtol=2e-5, atol=1e-7)      # :62-64
LL_RTOL = 2e-5                          # :65-67
FIT_RTOL = 1e-5                         # :122-124
QUIET = JsonlLogger(None, echo=False)
BDG, BD, LARGE = em_bdg.KERNEL_NAME, em_bd.KERNEL_NAME, em_large_g.KERNEL_NAME

# (n, g, k, wb, tile): the shapes of tests/test_pallas_large.py:41-48.
SHAPES = [
    (256, 64, 4, 32, 64),      # tiny, many empty blocks
    (512, 300, 5, 64, 128),    # ragged blocks
    (512, 2048, 4, 256, 128),  # beyond one block per tile
]


def _rows(n, g, r=2, seed=0, hub=False):
    rng = np.random.default_rng(seed)
    trip = rng.integers(0, g, size=(n, 3), dtype=np.int32)
    if hub:  # a query gene in 30% of the rows, at every position
        for pos in range(3):
            trip[rng.random(n) < 0.3, pos] = g // 3
    ratings = rng.integers(0, r, size=(n,), dtype=np.int32)
    weights = (rng.random(n) > 0.1).astype(np.float32)  # some inert rows
    return trip, ratings, weights


def _states(g, k, s, r=2, seed=0):
    st = init_state(g, k, r, samples=s, seed=seed + 100)
    th, p = st.numpy()
    return st, jnp.asarray(th), jnp.asarray(p)


def _assert_stats(out, want):
    np.testing.assert_allclose(out.theta_hat.numpy(), np.asarray(want.theta_hat), **THETA_TOL)
    np.testing.assert_allclose(out.p_hat.numpy(), np.asarray(want.p_hat), **P_TOL)
    np.testing.assert_allclose(out.loglik.numpy(), np.asarray(want.loglik), rtol=LL_RTOL)


def _jax_plan_batch(trip, ratings, weights, plan):
    return jem.Batch(
        triplets=jnp.asarray(trip), ratings=jnp.asarray(ratings),
        weights=jnp.asarray(weights), scatter_perm=jnp.asarray(plan.perm),
        scatter_lid=jnp.asarray(plan.lid), scatter_block=jnp.asarray(plan.block),
    )


def _jax_bdg_batch(trip, ratings, weights, g, wb1, wb, tile):
    g1 = jbdg.make_g1_plan(trip, g, wb1=wb1, tile=tile)
    t_, r_, w_ = jbdg.apply_g1_order(g1, trip, ratings, weights)
    plan = jlarge.make_scatter_plan(t_, g, wb=wb, tile=tile, positions=(1, 2))
    return jem.Batch(
        triplets=jnp.asarray(t_), ratings=jnp.asarray(r_), weights=jnp.asarray(w_),
        scatter_perm=jnp.asarray(plan.perm), scatter_lid=jnp.asarray(plan.lid),
        scatter_block=jnp.asarray(plan.block), g1_lid=jnp.asarray(g1.lid1),
        g1_block=jnp.asarray(g1.blk1),
    )


def _port_bdg_batch(trip, ratings, weights, g, wb1, wb):
    g1 = em_bdg.make_g1_plan(trip, g, wb1=wb1)
    t_, r_, w_ = em_bdg.apply_g1_order(g1, trip, ratings, weights)
    plan = em_large_g.make_scatter_plan(t_, g, wb=wb, positions=(1, 2))
    return tem.make_batch(t_, r_, w_, "cpu", scatter=plan, g1=g1)


# ---------------------------------------------------------------- plans


@pytest.mark.parametrize("positions", [None, (1, 2)])
@pytest.mark.parametrize(
    "n,g,wb,tile,hub",
    [
        (256, 64, 32, 64, False),     # empty blocks
        (500, 300, 64, 128, False),   # G not a multiple of wb
        (512, 5000, 256, 128, False),  # most blocks empty
        (1000, 700, 64, 128, True),   # a hub gene in 30% of the rows
    ],
)
def test_scatter_plan_matches_reference(n, g, wb, tile, hub, positions):
    """Same real slots in the same order with the same local ids and
    blocks as the reference's plan, and not one pad slot."""
    trip, _, _ = _rows(n, g, seed=n + g, hub=hub)
    ref = jlarge.make_scatter_plan(trip, g, wb=wb, tile=tile, positions=positions)
    got = em_large_g.make_scatter_plan(trip, g, wb=wb, positions=positions)
    real = ref.lid >= 0
    n_slots = n * (3 if positions is None else len(positions))
    assert got.perm.shape == (n_slots,) and real.sum() == n_slots
    np.testing.assert_array_equal(got.perm, ref.perm[real])
    np.testing.assert_array_equal(got.lid, ref.lid[real])
    ref_block = np.repeat(ref.block, tile)[real]
    np.testing.assert_array_equal(np.repeat(np.arange(got.n_blocks), np.diff(got.offsets)),
                                  ref_block)
    assert got.n_blocks == ref.n_blocks and got.offsets[0] == 0
    assert got.offsets[-1] == n_slots and np.all(np.diff(got.offsets) >= 0)


@pytest.mark.parametrize(
    "n,g,wb1,tile,hub",
    [(256, 64, 32, 64, False), (500, 300, 64, 128, False), (512, 5000, 256, 128, False),
     (1000, 700, 64, 128, True)],
)
def test_g1_plan_matches_reference(n, g, wb1, tile, hub):
    """The port's g1 plan is the reference's with the pad rows taken out:
    same row order, local ids and blocks; apply_g1_order gives the
    reference's real rows."""
    trip, ratings, weights = _rows(n, g, seed=n * 3 + g, hub=hub)
    ref = jbdg.make_g1_plan(trip, g, wb1=wb1, tile=tile)
    got = em_bdg.make_g1_plan(trip, g, wb1=wb1)
    real = ref.order >= 0
    assert got.order.shape == (n,) and real.sum() == n
    np.testing.assert_array_equal(got.order, ref.order[real])
    np.testing.assert_array_equal(got.lid1, ref.lid1[real])
    np.testing.assert_array_equal(np.repeat(np.arange(got.n_blocks), np.diff(got.offsets)),
                                  np.repeat(ref.blk1, tile)[real])
    assert got.n_blocks == ref.n_blocks and got.offsets[-1] == n
    want = jbdg.apply_g1_order(ref, trip, ratings, weights)
    for a, b in zip(em_bdg.apply_g1_order(got, trip, ratings, weights), want):
        np.testing.assert_array_equal(a, b[real])


def test_plans_refuse_out_of_range_genes():
    trip = np.array([[0, 1, 2], [3, 9, 1]], np.int32)
    with pytest.raises(ValueError):
        em_large_g.make_scatter_plan(trip, 9)
    with pytest.raises(ValueError):
        em_bdg.make_g1_plan(-trip, 9)


# ------------------------------------------------- kernels, plain versions


@pytest.mark.parametrize("s", [1, 3, 20])
@pytest.mark.parametrize("n,g,k,wb,tile", SHAPES)
def test_large_g_plain_matches_reference_kernel(n, g, k, wb, tile, s):
    """K6: ``large_g_ensemble_stats`` (the reference's per-restart E-step
    kernel and its plan scatter, interpret mode)."""
    trip, ratings, weights = _rows(n, g, seed=g)
    st, th, p = _states(g, k, s, seed=g)
    jplan = jlarge.make_scatter_plan(trip, g, wb=wb, tile=tile)
    want = jlarge.large_g_ensemble_stats(
        th, p, _jax_plan_batch(trip, ratings, weights, jplan), tile_b=tile, wb=wb,
        n_blocks=jplan.n_blocks, interpret=True,
    )
    plan = em_large_g.make_scatter_plan(trip, g, wb=wb)
    tb = tem.make_batch(trip, ratings, weights, "cpu", scatter=plan)
    _assert_stats(em_large_g.large_g_ensemble_stats(st.theta, st.p, tb, wb=wb), want)


@pytest.mark.parametrize("s", [1, 3, 20])
@pytest.mark.parametrize("n,g,k,wb,tile", SHAPES)
def test_bd_plain_matches_reference_kernel(n, g, k, wb, tile, s):
    """K5a + K5b: ``bd_em_ensemble_stats`` (block-diagonal E-step and plan
    scatter, interpret mode)."""
    from trigenicinteractionpredictor_tpu.ops.pallas_em_bd import bd_em_ensemble_stats

    trip, ratings, weights = _rows(n, g, seed=g + 1)
    st, th, p = _states(g, k, s, seed=g + 1)
    jplan = jlarge.make_scatter_plan(trip, g, wb=wb, tile=tile)
    want = bd_em_ensemble_stats(
        th, p, _jax_plan_batch(trip, ratings, weights, jplan), tile_b=tile, wb=wb,
        n_blocks=jplan.n_blocks, interpret=True,
    )
    plan = em_large_g.make_scatter_plan(trip, g, wb=wb)
    tb = tem.make_batch(trip, ratings, weights, "cpu", scatter=plan)
    n_launch = em_bd.em_streams.launches, em_bd.plan_scatter.launches
    _assert_stats(em_bd.bd_em_ensemble_stats(st.theta, st.p, tb, wb=wb), want)
    assert (em_bd.em_streams.launches, em_bd.plan_scatter.launches) == n_launch


@pytest.mark.parametrize("s", [1, 3, 20])
@pytest.mark.parametrize("n,g,k,wb,tile", SHAPES)
def test_bdg_plain_matches_reference_kernel(n, g, k, wb, tile, s):
    """K4 + K5b: ``bdg_em_ensemble_stats`` (g1-fused block-diagonal E-step,
    interpret mode) with gene blocks of wb1 = wb; the reference pads its
    g1-ordered rows, the port does not -- the stats are order-free."""
    trip, ratings, weights = _rows(n, g, seed=g + 2)
    st, th, p = _states(g, k, s, seed=g + 2)
    want = jbdg.bdg_em_ensemble_stats(
        th, p, _jax_bdg_batch(trip, ratings, weights, g, wb, wb, tile), tile_b=tile,
        wb1=wb, wb=wb, interpret=True,
    )
    tb = _port_bdg_batch(trip, ratings, weights, g, wb, wb)
    n_launch = em_bdg.bdg_estep.launches
    _assert_stats(em_bdg.bdg_em_ensemble_stats(st.theta, st.p, tb, wb1=wb, wb=wb), want)
    assert em_bdg.bdg_estep.launches == n_launch


@pytest.mark.parametrize("s", [3, 20])
@pytest.mark.parametrize("g1_fused", [True, False])
def test_single_launch_matches_reference_grouped_fn(g1_fused, s):
    """The reference's wide-S plan routes (``pallas-bdg-plan-grouped``,
    ``pallas-bd-plan-grouped``: restart groups under lax.map, with a
    remainder group at S = 3) against the port's one call for all S."""
    from trigenicinteractionpredictor_tpu.ops.dispatch import _grouped_bd_plan_fn

    n, g, k, tile, wb = 384, 60, 4, 128, 32
    trip, ratings, weights = _rows(n, g, seed=13)
    st, th, p = _states(g, k, s, seed=13)
    fn = _grouped_bd_plan_fn(tile, g, group=2 if s == 3 else 10, wb=wb, g1_fused=g1_fused)
    if g1_fused:
        assert fn.kernel_name == "pallas-bdg-plan-grouped"
        want = fn(th, p, _jax_bdg_batch(trip, ratings, weights, g, fn.wb1, wb, tile))
        got = em_bdg.bdg_em_ensemble_stats(
            st.theta, st.p, _port_bdg_batch(trip, ratings, weights, g, fn.wb1, wb),
            wb1=fn.wb1, wb=wb,
        )
    else:
        assert fn.kernel_name == "pallas-bd-plan-grouped"
        jplan = jlarge.make_scatter_plan(trip, g, wb=wb, tile=tile)
        want = fn(th, p, _jax_plan_batch(trip, ratings, weights, jplan))
        plan = em_large_g.make_scatter_plan(trip, g, wb=wb)
        got = em_bd.bd_em_ensemble_stats(
            st.theta, st.p, tem.make_batch(trip, ratings, weights, "cpu", scatter=plan),
            wb=wb,
        )
    _assert_stats(got, want)


def test_wrong_plan_fails_on_the_cpu():
    """The plain scatter consumes the plan: a plan of other rows, or of
    another block width, changes the stats; a batch without a plan
    raises."""
    n, g, k, wb = 256, 64, 4, 32
    trip, ratings, weights = _rows(n, g, seed=5)
    st, _, _ = _states(g, k, 2, seed=5)
    right = em_sufficient = tem.em_sufficient_stats(
        st.theta, st.p, tem.make_batch(trip, ratings, weights, "cpu"))
    plan = em_large_g.make_scatter_plan(trip, g, wb=wb)
    tb = tem.make_batch(trip, ratings, weights, "cpu", scatter=plan)
    np.testing.assert_allclose(em_bd.bd_em_ensemble_stats(st.theta, st.p, tb, wb=wb)
                               .theta_hat.numpy(), right.theta_hat.numpy(), **THETA_TOL)
    other = em_large_g.make_scatter_plan(np.roll(trip, 1, axis=0), g, wb=wb)
    for bad, bad_wb in ((tem.make_batch(trip, ratings, weights, "cpu", scatter=other), wb),
                        (tb, wb // 2)):
        got = em_bd.bd_em_ensemble_stats(st.theta, st.p, bad, wb=bad_wb).theta_hat
        assert not np.allclose(got.numpy(), em_sufficient.theta_hat.numpy(), **THETA_TOL)
    for fn in (em_bd.bd_em_ensemble_stats, em_large_g.large_g_ensemble_stats,
               em_bdg.bdg_em_ensemble_stats):
        with pytest.raises(ValueError, match="plan"):
            fn(st.theta, st.p, tem.make_batch(trip, ratings, weights, "cpu"))


def _piecewise_scatter(streams, plan, n_genes, k, piece, out):
    """K5b's algorithm on the host, in the kernel's own order: the sorted
    slots in pieces of ``piece``; a segment inside a piece is added into
    ``out`` by that piece; one that began in an earlier piece leaves a head
    and one that runs on a tail in ``part``, each piece its first and last
    gene in ``edge``; then the fix-up gives each run-on segment to the
    piece it began in, from ``edge`` alone."""
    P, B, SK = streams.shape
    vals = streams.reshape(P * B, SK)
    L = len(plan.perm)
    block = np.searchsorted(plan.offsets, np.arange(L), side="right") - 1
    gene = block * plan.wb + plan.lid
    n_pieces = -(-L // piece)
    part = np.full((n_pieces, 2, SK), np.nan)
    edge = np.zeros((n_pieces, 2), np.int64)
    flat = out.transpose(1, 0, 2).reshape(n_genes, SK)  # [G, S*K]
    for j in range(n_pieces):
        a, e = j * piece, min(L, (j + 1) * piece)
        prev = gene[a - 1] if a > 0 else -1
        nxt = gene[e] if e < L else -1
        edge[j] = gene[a], gene[e - 1]
        start = a
        for i in range(a + 1, e + 1):
            if i < e and gene[i] == gene[start]:
                continue
            g, acc = gene[start], vals[plan.perm[start:i]].sum(0)
            if start == a and prev == g:
                part[j, 0] = acc
            elif i == e and nxt == g:
                part[j, 1] = acc
            else:
                flat[g] += acc
            start = i
    for j in range(n_pieces - 1):
        g = edge[j, 1]
        if edge[j + 1, 0] != g or (j > 0 and edge[j - 1, 1] == g):
            continue
        acc = part[j, 1].copy()
        m = j + 1
        while True:
            acc += part[m, 0]
            if m + 1 >= n_pieces or edge[m + 1, 0] != g:
                break
            m += 1
        flat[g] += acc
    return flat.reshape(n_genes, SK // k, k).transpose(1, 0, 2)


@pytest.mark.parametrize("s,k,vec,piece", [(1, 10, 2, 512), (10, 10, 4, 64), (3, 7, 1, 256),
                                           (50, 10, 4, 64), (40, 4, 4, 64), (1, 1, 1, 1024),
                                           (43, 3, 1, 64)])
@pytest.mark.parametrize("positions", [None, (1, 2)])
def test_scatter_launch_plan_and_piecewise_sum(s, k, vec, piece, positions):
    """K5b's host side: ``scatter_plan`` gives the piece (the power of two
    whose rows come to about 32 KB, within 32..1024), the copy width and the shared memory of the
    kernel's layout at S*K = 10 (K6's stage), 100 (the table's shape), 21,
    500, 160, 1 and 129; and the kernel's piecewise
    algorithm, run on the host at that piece size, equals
    ``plan_scatter_reference`` with a hub gene that spans many pieces, a
    ragged last piece, empty gene blocks, and ``out`` holding another
    position's share."""
    sk = s * k
    launch = em_bd.scatter_plan(sk)
    width = min(sk, em_bd.COL_TILE)
    assert launch == (piece, vec, 4 * (2 * piece * width + 7 * piece + 8))
    assert sk % launch.vec == 0 and 3 * (launch.smem + 1024) <= 233_472
    n, g, wb = 6001, 2000, 256
    trip, _, _ = _rows(n, g, seed=sk, hub=True)
    plan = em_large_g.make_scatter_plan(trip, g, wb=wb, positions=positions)
    rng = np.random.default_rng(sk)
    streams = rng.random((len(positions or (0, 1, 2)), n, sk))
    base = rng.random((s, g, k))
    hub_slots = int((trip[:, list(positions or (0, 1, 2))] == g // 3).sum())
    assert hub_slots > 3 * piece
    want = em_bd.plan_scatter_reference(
        torch.as_tensor(streams), torch.as_tensor(plan.perm), torch.as_tensor(plan.lid),
        torch.as_tensor(plan.offsets), wb, g, k, out=torch.as_tensor(base.copy()))
    got = _piecewise_scatter(streams, plan, g, k, launch.piece, base.copy())
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)


def test_row_chunks_of_a_planned_batch():
    """The plain sweep's row chunks drop the plans (they describe the
    whole batch) and keep its stats."""
    trip, ratings, weights = _rows(300, 40, seed=2)
    st, _, _ = _states(40, 3, 2, seed=2)
    plan = em_large_g.make_scatter_plan(trip, 40, wb=16)
    tb = tem.make_batch(trip, ratings, weights, "cpu", scatter=plan)
    whole = tem.em_sufficient_stats(st.theta, st.p, tb)
    chunked = tem.em_sufficient_stats(st.theta, st.p, tb, row_chunk=128)
    np.testing.assert_allclose(chunked.theta_hat.numpy(), whole.theta_hat.numpy(),
                               rtol=2e-6, atol=1e-6)


# ------------------------------------------------------------ the route


@pytest.mark.parametrize(
    "k,s,g,n_rows,expected",
    [
        (10, 10, 1000, 104858, em_bdr.KERNEL_NAME),
        (10, 10, 4500, 104858, em_bdr.KERNEL_NAME),
        (10, 2, 4501, 104858, BDG),
        (10, 10, 10_000, 104858, BDG),
        (10, 50, 10_000, 104858, BDG),
        (10, 10, 100_000, 104858, BDG),
        (10, 2, 100_000, 104858, BDG),     # tile 256: the reference's tile 512 gives bd-plan
        (10, 10, 100_000, 50_000, BD),     # pad estimate past a quarter of the rows
        (10, 10, 500_000, 104858, BD),
        (10, 20, 500_000, 104858, BD),
        (10, 1, 12_376, 104858, em_bdr.KERNEL_NAME),
        (10, 1, dispatch.LARGE_G_MIN_G, 104858, LARGE),
        (10, 1, 500_000, 104858, LARGE),
        (20, 10, 100_000, 0, BDG),
        (20, 1, 100_000, 0, LARGE),
        (25, 10, 100_000, 104858, em_large_k.KERNEL_NAME),
        (65, 10, 100_000, 104858, em_large_k.KERNEL_NAME),  # K3 has no G cap
        (72, 1, 100_000, 104858, em_large_k.KERNEL_NAME),
        (73, 10, 100_000, 104858, "torch"),
    ],
)
def test_route(k, s, g, n_rows, expected):
    assert dispatch.route("cuda", 3, k, 2, s, n_genes=g, n_rows=n_rows) == expected
    assert dispatch.route("cpu", 3, k, 2, s, n_genes=g, n_rows=n_rows) == "torch"
    assert dispatch.route("cuda", 2, k, 2, s, n_genes=g, n_rows=n_rows) == "torch"
    fn = dispatch.resolve_stats_fn("cuda", 3, g, k, s, n_ratings=2, n_rows=n_rows)
    assert fn.kernel_name == expected
    assert getattr(fn, "needs_g1plan", False) == (expected == BDG)
    assert getattr(fn, "needs_plan", False) == (expected in (BD, LARGE))
    for backend in ("jnp", "", None):
        plain = dispatch.resolve_stats_fn("cuda", 3, g, k, s, backend=backend, row_chunk=64)
        assert plain.kernel_name == "torch" and plain.row_chunk == 64
    assert dispatch.resolve_stats_fn("cuda", 3, g, k, s, backend="pallas",
                                     n_rows=n_rows).kernel_name == expected


def test_route_boundaries_follow_the_reference():
    """The bdr / large-G boundary at S = 1 is the reference's at K = 10,
    and the bdg rule is the reference's pad-fraction rule."""
    from trigenicinteractionpredictor_tpu.ops import dispatch as jdispatch

    def ref_name(g, s):
        return jdispatch.resolve_stats_fn("pallas", g, 10, 512, n_samples=s,
                                          n_rows=104858).kernel_name

    assert ref_name(dispatch.LARGE_G_MIN_G - 1, 1) == "pallas-bdr"
    assert ref_name(dispatch.LARGE_G_MIN_G, 1) == "pallas-large-g"
    assert dispatch._BDR_BD_PLAN_CROSSOVER_G == jdispatch._BDR_BD_PLAN_CROSSOVER_G
    for g in (5000, 100_000, 500_000):
        for n_rows in (0, 4096, 104858):
            assert dispatch._bdg_pad_ok(g, 256, n_rows) == jdispatch._bdg_pad_ok(g, 256, n_rows)


def test_bdg_plan_covers_k1_range():
    for k in range(1, em_bdr.MAX_K + 1):
        for r in (2, 3):
            tile, wb1 = em_bdg.bdg_plan(k, r)
            assert em_bdg._smem_bytes(k, r, tile, wb1) <= 232_448
    assert em_bdg.bdg_plan(10, 2) == (64, 128)
    assert em_bdg.bdg_plan(21, 2) is None


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        dispatch.resolve_stats_fn("cuda", 3, 1000, 10, 10, backend="triton")


def test_fit_backend_jnp_runs_the_plain_sweep(monkeypatch):
    """The trainer hands ``cfg.engine.backend`` to dispatch: on the card's
    route table (resolved here as for a CUDA device) ``jnp`` picks the
    plain sweep and ``auto`` a kernel, and the fit records what ran."""
    seen = []
    real = dispatch.resolve_stats_fn

    def as_on_card(device, *args, **kwargs):
        fn = real("cuda", *args, **kwargs)
        seen.append((kwargs["backend"], fn.kernel_name))
        return fn

    monkeypatch.setattr(trainer, "resolve_stats_fn", as_on_card)
    ds, _, _ = sample_synthetic_dataset(400, 20, 3, n_ratings=2, seed=2)
    results = {}
    for backend in ("jnp", "auto"):
        cfg = Config(train=TrainConfig(k=3, sweeps=4, samples=2, likelihood_freq=2),
                     engine=EngineConfig(backend=backend))
        results[backend] = fit(cfg, ds, device="cpu", logger=QUIET)
    assert seen == [("jnp", "torch"), ("auto", em_bdr.KERNEL_NAME)]
    assert results["jnp"].dispatch["kernel"] == "torch"
    assert results["jnp"].dispatch["backend"] == "jnp"
    assert results["auto"].dispatch["kernel"] == em_bdr.KERNEL_NAME
    np.testing.assert_allclose(results["jnp"].final_loglik, results["auto"].final_loglik,
                               rtol=FIT_RTOL)


# ------------------------------------------------------------------ fits


@pytest.mark.parametrize("route", [BDG, BD, LARGE])
def test_fit_through_plan_route_matches_reference_fit(route):
    """G = 6000 through each plan route on the CPU (the trainer builds and
    attaches the plans; each wrapper runs its plain version) against the
    reference's ``fit(backend="pallas")`` from the same initial states."""
    g, k, s = 6000, 3, 1 if route == LARGE else 2
    ds, _, _ = sample_synthetic_dataset(1024, g, k, seed=4)
    cfg = Config(
        train=TrainConfig(k=k, sweeps=3, samples=s, likelihood_freq=1, seed=0),
        engine=EngineConfig(backend="pallas", tile_b=128, batch_pad_multiple=128),
    )
    st = init_state(g, k, 2, samples=s, seed=9)
    th, p = st.numpy()
    log = []

    class Log:
        def log(self, event, **kw):
            log.append((event, kw))

    stats_fn = dispatch.stats_fn_for(route, k, 2)
    got = fit(cfg, ds, device="cpu", logger=Log(), init_states=st, stats_fn=stats_fn)
    want = jfit(cfg, ds, logger=QUIET, init_states=JState(theta=th, p=p))
    assert got.dispatch["kernel"] == route
    plans = [kw for event, kw in log if event == "backend"]
    assert len(plans) == 1 and plans[0]["kernel"] == route
    assert plans[0]["plan_rows"] == (2 if route == BDG else 3) * ds.n_rows
    np.testing.assert_allclose(got.final_loglik, want.final_loglik, rtol=FIT_RTOL)
    np.testing.assert_allclose(got.ll_trace, want.ll_trace, rtol=FIT_RTOL)


def test_cli_large_g_drive_on_cpu(tmp_path, capsys):
    """``synth -g 6000`` -> ``fit --device cpu`` -> ``predict``."""
    data = str(tmp_path / "synth.npz")
    assert cli_main(["synth", "-o", data, "-n", "4096", "-g", "6000", "-k", "4"]) == 0
    out = str(tmp_path / "fit")
    assert cli_main(["fit", "-f", data, "-k", "4", "-i", "4", "-s", "2", "-n", "2",
                     "-o", out, "--device", "cpu"]) == 0
    with open(os.path.join(out, "report.json")) as fh:
        report = json.load(fh)
    assert np.isfinite(report["auc"]) and report["sweeps"] == 4
    pred = str(tmp_path / "pred.tsv")
    assert cli_main(["predict", "-f", data, "--checkpoint",
                     os.path.join(out, "model.ckpt.npz"), "-o", pred,
                     "--device", "cpu"]) == 0
    with open(pred) as fh:
        rows = fh.read().strip().splitlines()
    assert len(rows) == 4097
    scores = np.array([float(r.split("\t")[-1]) for r in rows[1:]])
    assert np.all((scores >= 0) & (scores <= 1))
