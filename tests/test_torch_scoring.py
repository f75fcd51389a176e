"""PyTorch port vs the JAX reference: scoring (ops/scoring.py), the plain
version of the K2 scoring kernel (ops/score.py) and the ranking metrics
(ops/metrics.py), on the CPU.

Tolerances are the reference's own (tests/test_metrics.py): the pallas
scorer against the loop scorer rtol 3e-5 / atol 3e-6; the exact-f32
scorers rtol 1e-6 / atol 1e-7; AUC and AP 1e-6 (1e-5 against the numpy
rank reference).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState as JState
from trigenicinteractionpredictor_tpu.ops import metrics as jmetrics
from trigenicinteractionpredictor_tpu.ops import scoring as jscoring
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState, init_state
from trigenicinteractionpredictor_tpu_torch.ops import metrics, score, scoring

torch.set_num_threads(2)


def _case(n, g, k, r=2, s=3, arity=3, seed=0):
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=r, seed=seed, arity=arity)
    st = init_state(g, k, r, arity=arity, samples=s, seed=seed + 1)
    th, p = st.numpy()
    return ds, st, JState(jnp.asarray(th), jnp.asarray(p))


@pytest.mark.parametrize("arity", [3, 2])
@pytest.mark.parametrize("r", [2, 3])
def test_predict_proba_matches_jax(arity, r):
    ds, st, jst = _case(400, 25, 4, r=r, arity=arity, seed=arity + r)
    trips = torch.as_tensor(ds.triplets)
    one = ModelState(st.theta[0], st.p[0])
    want = np.asarray(
        jscoring.predict_proba(JState(jst.theta[0], jst.p[0]), jnp.asarray(ds.triplets))
    )
    got = scoring.predict_proba(one, trips).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(
        scoring.ensemble_predict_interaction(st, trips).numpy(),
        np.asarray(jscoring.ensemble_predict_interaction(jst, jnp.asarray(ds.triplets))),
        rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("r,interact", [(2, 1), (3, 2)])
def test_k2_plain_matches_pallas_score_interpret(r, interact):
    """K2's plain version (the wrapper on a CPU tensor) against the JAX
    scoring kernel in interpret mode and the JAX ensemble scorer, on a
    ragged row count (the JAX kernel's padding rows are dropped)."""
    from trigenicinteractionpredictor_tpu.ops.pallas_score import _pallas_score

    ds, st, jst = _case(777, 40, 4, r=r, s=3, seed=9)
    n = ds.n_rows
    padded = np.zeros((896, 3), np.int32)
    padded[:n] = ds.triplets
    d = _pallas_score(jst.theta, jst.p, jnp.asarray(padded), tile_b=128, interpret=True)
    want_kernel = np.asarray(d)[:n, interact, :].mean(-1)
    want_loop = np.asarray(
        jscoring.ensemble_predict_interaction(jst, jnp.asarray(ds.triplets), interact)
    )
    launches = score.ensemble_score.launches
    got = score.ensemble_score(
        st.theta, st.p, torch.as_tensor(ds.triplets, dtype=torch.int32), interact
    ).numpy()
    assert score.ensemble_score.launches == launches  # CPU: plain, no launch
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want_kernel, rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(got, want_loop, rtol=1e-6, atol=1e-7)


def test_serve_matches_jax_serve():
    """Port serving (CPU: plain scorer) == JAX serve_predict_interaction
    with fast=False, ensemble and single-state, with a non-block-multiple
    tail."""
    ds, st, jst = _case(1000, 40, 4, s=3, seed=5)
    want = jscoring.serve_predict_interaction(jst, ds.triplets, block_rows=256, fast=False)
    got = scoring.serve_predict_interaction(st, ds.triplets, block_rows=256)
    assert got.dtype == np.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    one = ModelState(st.theta[1], st.p[1])
    want1 = jscoring.serve_predict_interaction(
        JState(jst.theta[1], jst.p[1]), ds.triplets, block_rows=300, fast=False
    )
    got1 = scoring.serve_predict_interaction(one, ds.triplets, block_rows=300)
    np.testing.assert_allclose(got1, want1, rtol=1e-6, atol=1e-7)
    assert scoring.serve_predict_interaction(st, np.zeros((0, 3), np.int32)).shape == (0,)
    with pytest.raises(ValueError):
        scoring.serve_predict_interaction(st, np.full((2, 3), 40, np.int32))


def test_score_kernel_range():
    """K2 takes every K the earlier plan took (1..115) and on to 136, with
    no cap on G or S: a block of wkl x wr warps (at most 8) whose (k,l)
    chunks of 32 * wkl cover K^2 with the least padding, inside one block's
    shared memory, and inside half of it up to K = 50 (two blocks per SM)."""
    for k in range(1, 137):
        plan = score.score_plan(k)
        chunk = score.WARP_KL * plan.wkl
        assert 1 <= plan.wkl * plan.wr <= score.MAX_WARPS and plan.wr == 8 // plan.wkl
        assert plan.klp % chunk == 0 and k * k <= plan.klp < k * k + chunk
        assert plan.smem <= 232_448 - 1024
        if k <= 50:
            assert 2 * (plan.smem + 1024) <= 233_472
    assert score.score_plan(10)[:3] == (4, 2, 128)    # the default job
    assert score.score_plan(50)[:3] == (8, 1, 2560)   # the K-sweep job's largest unit
    assert score.score_plan(137) is None and score.score_plan(0) is None


@pytest.mark.parametrize("k,r,interact", [(4, 2, 1), (10, 2, 1), (7, 3, 2), (33, 2, 0)])
def test_k2_packed_product_matches_plain_scorer(k, r, interact):
    """The kernel's algebra on its own host-side pieces: the packed slice
    P[s, m, (k,l)] (``pack_p_reference``, zero-padded to the plan's chunked
    width) multiplied by th3, then folded with th1 th2 over the flat (k,l)
    axis, equals the plain scorer."""
    ds, st, _ = _case(300, 30, k, r=r, s=2, seed=k)
    plan = score.score_plan(k)
    packed = score.pack_p_reference(st.p, interact, plan.klp)
    assert packed.shape == (2, k, plan.klp) and packed.is_contiguous()
    np.testing.assert_array_equal(packed[:, :, k * k:].numpy(), 0.0)
    np.testing.assert_array_equal(packed[1, 2, 1 * k + 3].numpy(),
                                  st.p[1, 1, 3, 2, interact].numpy())
    idx = torch.as_tensor(ds.triplets).long()
    th1, th2, th3 = (st.theta[:, idx[:, q], :] for q in range(3))
    c = torch.matmul(th3, packed)                                   # [S, B, KLP]
    w = (th1.unsqueeze(-1) * th2.unsqueeze(-2)).reshape(2, -1, k * k)
    got = (c[..., : k * k] * w).sum(-1).mean(0)
    want = score.ensemble_score_reference(
        st.theta, st.p, torch.as_tensor(ds.triplets, dtype=torch.int32), interact)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize(
    "device_type,ensemble,arity,k,fast,expected",
    [
        ("cuda", True, 3, 10, True, "cuda-score"),
        ("cuda", True, 3, 50, True, "cuda-score"),   # the K-sweep job's K = 50 unit
        ("cuda", True, 3, 64, True, "cuda-score"),
        ("cuda", True, 3, 115, True, "cuda-score"),  # the earlier plan's top K
        ("cuda", True, 3, 136, True, "cuda-score"),
        ("cuda", True, 3, 200, True, "torch"),       # past K2's plan: plain, by rule
        ("cuda", True, 3, 50, False, "torch"),
        ("cuda", False, 3, 50, True, "torch"),       # single state
        ("cuda", True, 2, 50, True, "torch"),        # digenic
        ("cpu", True, 3, 50, True, "torch"),
    ],
)
def test_serve_route(device_type, ensemble, arity, k, fast, expected):
    """serve_predict_interaction serves a K = 50 ensemble on CUDA through K2
    (it raised there past K = 32); the plain scorer only by explicit rule."""
    assert scoring.serve_route(device_type, ensemble, arity, k, fast) == expected


METRIC_CASES = {
    "perfect": ([0.9, 0.8, 0.2, 0.1], [1, 1, 0, 0], None),
    "inverted": ([0.1, 0.2, 0.8, 0.9], [1, 1, 0, 0], None),
    "all_tied": ([0.5, 0.5, 0.5, 0.5], [1, 0, 1, 0], None),
    "padded": ([0.9, 0.1, 0.8, 0.95, 0.05], [1, 0, 1, 0, 1], [1.0, 1.0, 1.0, 0.0, 0.0]),
    "padded_ap": ([0.9, 0.8, 0.7, 0.99], [1, 0, 1, 1], [1.0, 1.0, 1.0, 0.0]),
    "ap_basic": ([0.9, 0.8, 0.7, 0.6], [1, 0, 1, 0], None),
    "no_negatives": ([0.9, 0.8, 0.7, 0.6], [1, 1, 1, 1], None),
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metrics_match_jax(name):
    s, y, w = METRIC_CASES[name]
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.as_tensor(w)
    ts, ty = torch.as_tensor(s), torch.as_tensor(y)
    js, jy = jnp.asarray(s), jnp.asarray(y)
    assert abs(float(metrics.auc(ts, ty, tw)) - float(jmetrics.auc(js, jy, jw))) < 1e-6
    assert abs(
        float(metrics.average_precision(ts, ty, tw))
        - float(jmetrics.average_precision(js, jy, jw))
    ) < 1e-6


def test_metrics_tied_random_match_jax_and_rank_reference():
    """500 rows with many ties and 60 padding rows: the port's AUC equals
    the JAX one and scipy's average-rank statistic on the real rows."""
    from scipy import stats

    rng = np.random.default_rng(0)
    scores = np.round(rng.random(500), 2).astype(np.float32)
    labels = (rng.random(500) < 0.3).astype(np.int32)
    weights = np.ones(500, np.float32)
    weights[-60:] = 0.0
    got_auc = float(metrics.auc(torch.as_tensor(scores), torch.as_tensor(labels),
                                torch.as_tensor(weights)))
    got_ap = float(metrics.average_precision(torch.as_tensor(scores),
                                             torch.as_tensor(labels),
                                             torch.as_tensor(weights)))
    want_auc = float(jmetrics.auc(jnp.asarray(scores), jnp.asarray(labels),
                                  jnp.asarray(weights)))
    want_ap = float(jmetrics.average_precision(jnp.asarray(scores), jnp.asarray(labels),
                                               jnp.asarray(weights)))
    assert abs(got_auc - want_auc) < 1e-6 and abs(got_ap - want_ap) < 1e-6
    s, y = scores[:440].astype(np.float64), labels[:440]
    ranks = stats.rankdata(s)
    n_pos = y.sum()
    expected = (ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * (440 - n_pos))
    assert abs(got_auc - expected) < 1e-5
