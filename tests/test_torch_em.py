"""PyTorch port vs the JAX reference: the plain EM sweep (ops/em.py) and the
plain version of the K1 sweep kernel (ops/em_bdr.py), on the CPU.

The same inputs, made with numpy from a seed, go through both packages.
Tolerances are the reference's own (tests/test_kernel_parity.py:50-58):
theta_hat atol 1e-4, p_hat atol 1e-5, loglik rtol 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState as JState
from trigenicinteractionpredictor_tpu.ops import em as jem
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import (
    init_state,
    state_from_numpy,
)
from trigenicinteractionpredictor_tpu_torch.ops import dispatch, em_bdr
from trigenicinteractionpredictor_tpu_torch.ops import em as tem

import oracle

torch.set_num_threads(2)

THETA_ATOL = 1e-4   # reference tests/test_kernel_parity.py:50-52
P_ATOL = 1e-5       # reference tests/test_kernel_parity.py:53-55
LL_RTOL = 1e-5      # reference tests/test_kernel_parity.py:56-58


def _case(n, g, k, r, s, arity=3, seed=0, pad_to=None):
    """Dataset (optionally padded with weight-0 rows), numpy init [S,...],
    the JAX batch and the port batch."""
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=r, seed=seed, arity=arity)
    if pad_to:
        ds = ds.pad_to(pad_to)
    st = init_state(g, k, r, arity=arity, samples=s, seed=seed + 1)
    jb = jem.Batch(
        triplets=jnp.asarray(ds.triplets),
        ratings=jnp.asarray(ds.ratings),
        weights=jnp.asarray(ds.weights),
    )
    tb = tem.make_batch(ds.triplets, ds.ratings, ds.weights, "cpu")
    return ds, st, jb, tb


def _jax_stats(theta, p, jb):
    return jax.vmap(lambda th, pp: jem.em_sufficient_stats(th, pp, jb))(theta, p)


def _assert_stats(out, ref):
    np.testing.assert_allclose(
        out.theta_hat.numpy(), np.asarray(ref.theta_hat), atol=THETA_ATOL
    )
    np.testing.assert_allclose(out.p_hat.numpy(), np.asarray(ref.p_hat), atol=P_ATOL)
    np.testing.assert_allclose(out.loglik.numpy(), np.asarray(ref.loglik), rtol=LL_RTOL)


@pytest.mark.parametrize("arity", [3, 2])
@pytest.mark.parametrize("r", [2, 3])
def test_sufficient_stats_match_jax(arity, r):
    """Ragged input: 300 rows padded to 384 with weight-0 rows.  K keeps the
    p_hat cells at a few units of mass, where atol 1e-5 is ~10 float32 ulps."""
    k = 4 if arity == 3 else 6
    ds, st, jb, tb = _case(300, 24, k, r, 3, arity=arity, seed=arity * 10 + r, pad_to=128)
    assert (ds.weights == 0).sum() == 84
    th, p = st.numpy()
    ref = _jax_stats(th, p, jb)
    _assert_stats(tem.em_sufficient_stats(st.theta, st.p, tb), ref)
    # the single-state form is the ensemble form without the leading axis
    one = tem.em_sufficient_stats(st.theta[1], st.p[1], tb)
    np.testing.assert_allclose(
        one.theta_hat.numpy(), np.asarray(ref.theta_hat[1]), atol=THETA_ATOL
    )
    np.testing.assert_allclose(
        float(one.loglik), float(ref.loglik[1]), rtol=LL_RTOL
    )
    ll = tem.log_likelihood(st, tb)
    ll_ref = jax.vmap(lambda a, b: jem.log_likelihood(JState(a, b), jb))(th, p)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), rtol=LL_RTOL)
    np.testing.assert_allclose(
        tem.log_likelihood(st, tb, row_chunk=100).numpy(), ll.numpy(), rtol=LL_RTOL
    )


@pytest.mark.parametrize("theta_norm", ["degree", "rowsum"])
def test_normalize_matches_jax_keep_old_rules(theta_norm):
    """Genes absent from the rows keep their old theta row; p cells with no
    mass keep their old value -- in both normalization modes."""
    rng = np.random.default_rng(3)
    S, G, K, R = 2, 12, 3, 2
    st = init_state(G, K, R, samples=S, seed=4)
    th, p = st.numpy()
    theta_hat = rng.random((S, G, K)).astype(np.float32) * 3
    theta_hat[:, 5] = 0.0                         # absent gene
    p_hat = rng.random((S, K, K, K, R)).astype(np.float32)
    p_hat[:, 1, 2, 0] = 0.0                       # empty cell
    degrees = (theta_hat.sum(-1)[0] * 0 + rng.integers(1, 9, G)).astype(np.int32)
    degrees[5] = 0
    ll = np.zeros(S, np.float32)
    ref = jax.vmap(
        lambda a, b, c, d: jem.normalize_from_stats(
            JState(a, b), jem.SweepStats(c, d, jnp.float32(0)), jnp.asarray(degrees),
            theta_norm=theta_norm,
        )
    )(th, p, theta_hat, p_hat)
    out = tem.normalize_from_stats(
        st,
        tem.SweepStats(torch.as_tensor(theta_hat), torch.as_tensor(p_hat),
                       torch.as_tensor(ll)),
        torch.as_tensor(degrees),
        theta_norm=theta_norm,
    )
    np.testing.assert_allclose(out.theta.numpy(), np.asarray(ref.theta), rtol=1e-6)
    np.testing.assert_allclose(out.p.numpy(), np.asarray(ref.p), rtol=1e-6)
    np.testing.assert_array_equal(out.theta.numpy()[:, 5], th[:, 5])
    np.testing.assert_array_equal(out.p.numpy()[:, 1, 2, 0], p[:, 1, 2, 0])


@pytest.mark.parametrize("k,r", [(2, 2), (4, 3)])
def test_em_step_matches_numpy_oracle(k, r):
    """One sweep against the independent float64 oracle (tests/oracle.py),
    at the reference's own oracle tolerance (tests/test_oracle_parity.py)."""
    ds, _, _ = sample_synthetic_dataset(300, 15, k, n_ratings=r, seed=k * 10 + r)
    theta0, p0 = oracle.init_params(ds.n_genes, k, r, seed=7)
    degrees = ds.degrees()
    theta1, p1, ll = oracle.em_sweep(theta0, p0, ds.triplets, ds.ratings, degrees)
    new, ll_t = tem.em_step(
        state_from_numpy(theta0, p0),
        tem.make_batch(ds.triplets, ds.ratings, ds.weights, "cpu"),
        torch.as_tensor(degrees),
    )
    np.testing.assert_allclose(new.theta.numpy(), theta1, atol=2e-5)
    np.testing.assert_allclose(new.p.numpy(), p1, atol=2e-5)
    assert abs(float(ll_t) - ll) < 1e-2 * max(1.0, abs(ll) * 1e-4)


def test_likelihood_never_decreases():
    """EM monotonicity in float32 on the CPU, restart by restart."""
    ds, st, _, tb = _case(800, 40, 5, 2, 3, seed=9)
    deg = torch.as_tensor(ds.degrees())
    lls = []
    for _ in range(25):
        st, ll = tem.em_step(st, tb, deg)
        lls.append(ll.numpy().astype(np.float64))
    lls = np.stack(lls)
    assert np.all(np.diff(lls, axis=0) >= -1e-6 * np.abs(lls[:-1]))


@pytest.mark.parametrize("group", [0, 2, 1])
def test_k1_plain_matches_bdr_kernel_interpret(group):
    """K1's plain version (the wrapper on a CPU tensor) against the JAX bdr
    kernel in interpret mode on rating-sorted rows, set up as
    tests/test_kernel_parity.py::test_bdr_group_widths_match_jnp, and
    against the vmapped jnp stats.  K1 reads per-row ratings, so it takes
    the rows in their original order: the stats are order-free."""
    from trigenicinteractionpredictor_tpu.ops.pallas_em_bdr import bdr_em_ensemble_stats
    from trigenicinteractionpredictor_tpu.ops.pallas_em_rsorted import (
        apply_rating_sort,
        rating_sort_pad,
    )

    ds, st, jb, tb = _case(600, 50, 5, 2, 4, seed=21)
    th, p = st.numpy()
    plan = rating_sort_pad(ds.ratings, 2, tile=128)
    t_, r_, w_ = apply_rating_sort(plan, ds.triplets, ds.ratings, ds.weights)
    sorted_batch = jem.Batch(
        triplets=jnp.asarray(t_), ratings=jnp.asarray(r_),
        weights=jnp.asarray(w_), tile_rating=jnp.asarray(plan.tile_r),
    )
    kern = bdr_em_ensemble_stats(
        jnp.asarray(th), jnp.asarray(p), sorted_batch, tile_b=128, group=group,
        interpret=True,
    )
    launches = em_bdr.em_ensemble_stats.launches
    out = em_bdr.em_ensemble_stats(st.theta, st.p, tb)
    assert em_bdr.em_ensemble_stats.launches == launches  # CPU: plain, no launch
    np.testing.assert_allclose(
        out.theta_hat.numpy(), np.asarray(kern.theta_hat), atol=THETA_ATOL
    )
    np.testing.assert_allclose(out.loglik.numpy(), np.asarray(kern.loglik), rtol=LL_RTOL)
    _assert_stats(out, _jax_stats(th, p, jb))
    # and on the sorted, padded rows themselves
    sorted_tb = tem.make_batch(t_, r_, w_, "cpu")
    _assert_stats(em_bdr.em_ensemble_stats(st.theta, st.p, sorted_tb), _jax_stats(th, p, jb))


def test_k1_sweep_plan_range():
    """K1 takes K = 1..20 at R <= 3 (shared memory permitting) and refuses
    the rest, so dispatch sends those shapes to the plain sweep."""
    for k in range(1, 21):
        for r in (2, 3):
            tile, smem = em_bdr.sweep_plan(k, r)
            assert tile in (64, 32, 16, 8) and smem <= 232_448
    assert em_bdr.sweep_plan(10, 2)[0] == 64
    assert em_bdr.sweep_plan(21, 2) is None
    assert em_bdr.sweep_plan(0, 2) is None


@pytest.mark.parametrize(
    "device,arity,k,expected",
    [
        ("cpu", 3, 10, "torch"),
        ("cuda", 3, 10, "cuda-em-sweep"),
        ("cuda", 3, 20, "cuda-em-sweep"),
        ("cuda", 3, 25, "cuda-em-sweep-large-k"),  # outside K1's range: K3
        ("cuda", 3, 80, "torch"),      # past K3's range: the plain sweep
        ("cuda", 2, 10, "torch"),      # digenic: plain, as the reference
    ],
)
def test_dispatch(device, arity, k, expected):
    fn = dispatch.resolve_stats_fn(device, arity, 1000, k, 10)
    assert fn.kernel_name == expected
