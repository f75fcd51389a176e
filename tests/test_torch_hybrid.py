"""K7 (the hybrid sweep on pre-gathered theta rows) and its route, on the
CPU, against the JAX reference.

- The plain version of K7 (``ops/em_hybrid.py``) against the reference's
  hybrid Pallas kernel in interpret mode, on the shapes of
  tests/test_kernel_parity.py:87-120 plus one K >= 21 case.  Tolerances
  are that test's: theta_hat atol 1e-4, p_hat atol 1e-5, loglik rtol 1e-5.
- The port's ``route`` gives ``cuda-em-hybrid`` exactly where the
  reference's ``resolve_stats_fn`` gives ``pallas-hybrid``, and no
  stepwise route is a plan route.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.ops.dispatch import resolve_stats_fn as jresolve
from trigenicinteractionpredictor_tpu.ops.em import Batch as JBatch
from trigenicinteractionpredictor_tpu.ops.pallas_em_hybrid import hybrid_em_ensemble_stats
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu_torch.ops import (
    dispatch,
    em_bd,
    em_bdg,
    em_bdr,
    em_hybrid,
    em_large_g,
    em_large_k,
)
from trigenicinteractionpredictor_tpu_torch.ops.em import make_batch

torch.set_num_threads(2)

PLAN_ROUTES = {em_bdg.KERNEL_NAME, em_bd.KERNEL_NAME, em_large_g.KERNEL_NAME}


def _case(n, g, k, r, s, tile_b, seed=7):
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=r, seed=seed)
    ds = ds.pad_to(tile_b)
    st = init_state(g, k, r, samples=s, seed=seed + 1)
    return ds, st


@pytest.mark.parametrize(
    "n,g,k,r,s,tile_b",
    [
        (512, 40, 5, 2, 3, 256),
        (300, 32, 4, 3, 2, 128),    # ragged: pads 300 -> 384, R = 3
        (256, 1500, 6, 2, 2, 128),  # G past the one-hot kernel's comfort zone
        (256, 40, 21, 2, 2, 128),   # K in the hybrid kernel's range
    ],
)
def test_plain_version_matches_reference_hybrid_kernel(n, g, k, r, s, tile_b):
    ds, st = _case(n, g, k, r, s, tile_b)
    theta, p = st.numpy()
    want = hybrid_em_ensemble_stats(
        jnp.asarray(theta), jnp.asarray(p),
        JBatch(triplets=jnp.asarray(ds.triplets), ratings=jnp.asarray(ds.ratings),
               weights=jnp.asarray(ds.weights)),
        tile_b=tile_b, interpret=True,
    )
    tb = make_batch(ds.triplets, ds.ratings, ds.weights, "cpu")
    streams = em_hybrid.gather_rows(st.theta, tb.triplets)
    got = em_hybrid.em_ensemble_stats_reference(
        *streams, tb.triplets, tb.ratings, tb.weights, st.p, g, row_chunk=100)
    np.testing.assert_allclose(got.theta_hat.numpy(), np.asarray(want.theta_hat), atol=1e-4)
    np.testing.assert_allclose(got.p_hat.numpy(), np.asarray(want.p_hat), atol=1e-5)
    np.testing.assert_allclose(got.loglik.numpy(), np.asarray(want.loglik), rtol=1e-5)


def test_gather_rows_is_the_reference_layout():
    """th_pos[b, s*K + k] = thetas[s, trip[b, pos], k]: the reference's
    jnp.take of its [G, S*K] theta (ops/pallas_em_hybrid.py:178-187)."""
    ds, st = _case(100, 30, 4, 2, 3, 1)
    theta, _ = st.numpy()
    theta_all = jnp.transpose(jnp.asarray(theta), (1, 0, 2)).reshape(30, 12)
    got = em_hybrid.gather_rows(st.theta, torch.as_tensor(ds.triplets))
    for pos in range(3):
        want = jnp.take(theta_all, jnp.asarray(ds.triplets[:, pos]), axis=0)
        np.testing.assert_array_equal(got[pos].numpy(), np.asarray(want))


def test_wrapper_on_cpu_runs_the_plain_version():
    ds, st = _case(300, 25, 25, 3, 2, 1, seed=3)
    tb = make_batch(ds.triplets, ds.ratings, ds.weights, "cpu")
    launches = em_hybrid.hybrid_stats.launches
    got = dispatch.stats_fn_for(em_hybrid.KERNEL_NAME)(st.theta, st.p, tb)
    want = em_large_k.em_ensemble_stats_reference(st.theta, st.p, tb)
    assert em_hybrid.hybrid_stats.launches == launches
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def _reference_route(g, k, s, static_rows):
    try:
        fn = jresolve("pallas", g, k, 512, n_samples=s, static_rows=static_rows,
                      minibatch_rsort=not static_rows, n_rows=104_858)
    except ValueError:  # the reference refuses the shape (no tile fits)
        return None
    return getattr(fn, "kernel_name", None)


@pytest.mark.parametrize("static_rows", [True, False])
@pytest.mark.parametrize("s", [1, 2, 10])
def test_route_gives_k7_where_the_reference_gives_hybrid(s, static_rows):
    jax.config.update("jax_platforms", "cpu")
    for k in (21, 25, 32, 40, 50, 64):
        for g in range(1000, 10_001, 1000):
            want = _reference_route(g, k, s, static_rows) == "pallas-hybrid"
            got = dispatch.route("cuda", 3, k, 2, s, n_genes=g, n_rows=104_858,
                                 static_rows=static_rows)
            assert (got == em_hybrid.KERNEL_NAME) == want, (g, k, s, static_rows, got)
            assert got in (em_hybrid.KERNEL_NAME, em_large_k.KERNEL_NAME)


@pytest.mark.parametrize("s", [1, 2, 3, 5, 10])
def test_hybrid_band_edges_are_the_reference(s):
    """Each stepwise band of the table at its edges: G_lo - 1, G_lo, G_hi,
    G_hi + 1 (every K the table holds at this S)."""
    for i, (lo, hi) in enumerate(dispatch.HYBRID_BAND[s]):
        k = em_large_k.MIN_K + i
        for g in (lo - 1, lo, hi, hi + 1):
            want = _reference_route(g, k, s, static_rows=False) == "pallas-hybrid"
            assert dispatch.in_hybrid_band(k, s, g, static_rows=False) == want, (g, k, s)


def test_no_stepwise_route_is_a_plan_route():
    """Rows are reshuffled every epoch, so stepwise EM takes no route whose
    host plan bakes a row order; K <= 20 keeps K1 at any G."""
    for k in (2, 10, 20, 21, 25, 50, 64):
        for s in (1, 2, 10, 50):
            for g in (1000, 5000, 12_377, 100_000, 500_000):
                got = dispatch.route("cuda", 3, k, 2, s, n_genes=g, n_rows=104_858,
                                     static_rows=False)
                assert got not in PLAN_ROUTES, (k, s, g, got)
                if k <= 20:
                    assert got == em_bdr.KERNEL_NAME
    assert dispatch.route("cuda", 3, 10, 2, 10, n_genes=100_000) in PLAN_ROUTES


def test_resolve_stats_fn_takes_static_rows():
    fn = dispatch.resolve_stats_fn("cuda", 3, 6000, 25, 2, static_rows=False)
    assert fn.kernel_name == em_hybrid.KERNEL_NAME
    assert fn.stats is em_hybrid.em_ensemble_stats
    fn = dispatch.resolve_stats_fn("cuda", 3, 6000, 25, 2, static_rows=True)
    assert fn.kernel_name == em_large_k.KERNEL_NAME
    assert dispatch.resolve_stats_fn("cpu", 3, 6000, 25, 2, static_rows=False).kernel_name \
        == dispatch.PLAIN_NAME
