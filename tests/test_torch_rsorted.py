"""The rating-sorted fit path of the port (K9's plain version, its host
plan, and the trainer's classic and stepwise sort) against the JAX
reference, on the CPU.

Both packages get the same numpy-seeded data and initial arrays.  The
reference's kernel runs in Pallas interpret mode.  Tolerances: the host
plan is bit-equal (the stepwise group prep is held bit-equal in
tests/test_torch_stepwise.py); the sweep is held at the
reference's kernel-parity tolerances (theta_hat and p_hat atol 1e-4,
loglik rtol 1e-5; tests/test_kernel_parity.py:157-162); a classic fit at
the fit tolerances of tests/test_torch_stepwise.py (L rtol 1e-4, states
atol 1e-4); a stepwise fit at the reference's own stepwise-rsort ones
(states atol 2e-3, trace rtol 1e-4; tests/test_stepwise.py:239-248).
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trigenicinteractionpredictor_tpu.config import Config, EngineConfig, TrainConfig
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState as JState
from trigenicinteractionpredictor_tpu.ops import dispatch as jdispatch
from trigenicinteractionpredictor_tpu.ops import pallas_em_rsorted as jrs
from trigenicinteractionpredictor_tpu.ops.em import Batch as JBatch
from trigenicinteractionpredictor_tpu.train.trainer import fit as jfit
from trigenicinteractionpredictor_tpu.utils.logging import JsonlLogger
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu_torch.ops import em_bdr, em_rsorted
from trigenicinteractionpredictor_tpu_torch.ops.em import make_batch
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit

torch.set_num_threads(2)
QUIET = JsonlLogger(None, echo=False)


def _ratings(n, r, seed, empty=None):
    rng = np.random.default_rng(seed)
    rat = rng.integers(0, r, size=n, dtype=np.int32)
    if empty is not None:
        rat[rat == empty] = (empty + 1) % r
    return rat


@pytest.mark.parametrize(
    "n,r,tile,n_shards,n_tiles,empty",
    [(300, 2, 16, 1, 0, None), (300, 3, 16, 1, 0, 1), (512, 2, 64, 2, 0, None),
     (512, 3, 32, 2, 0, 0), (256, 2, 16, 1, 40, None), (256, 3, 64, 2, 10, 2),
     (1000, 3, 512, 1, 0, None)],
)
def test_rating_sort_is_bit_equal_to_reference(n, r, tile, n_shards, n_tiles, empty):
    """rating_sort_pad and apply_rating_sort: one and two shards, a forced
    tile count (common-length pad tiles inheriting the last class), an
    empty class (its lone pad tile), R = 2 and 3."""
    rat = _ratings(n, r, seed=n + r, empty=empty)
    rng = np.random.default_rng(1)
    trip = rng.integers(0, 50, size=(n, 3), dtype=np.int32)
    w = rng.random(n).astype(np.float32)
    got = em_rsorted.rating_sort_pad(rat, r, tile=tile, n_shards=n_shards, n_tiles=n_tiles)
    want = jrs.rating_sort_pad(rat, r, tile=tile, n_shards=n_shards, n_tiles=n_tiles)
    assert got.n_rows == want.n_rows
    for a, b in ((got.order, want.order), (got.tile_r, want.tile_r)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rows = em_rsorted.apply_rating_sort(got, trip, rat, w, n_shards=n_shards)
    for a, b in zip(rows, jrs.apply_rating_sort(want, trip, rat, w, n_shards=n_shards)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert not (rows[2] == 0).all()
    if empty is not None:  # the empty class has one tile, all weight 0
        t_r = got.tile_r.reshape(n_shards, -1)
        assert (t_r == empty).sum(axis=1).min() >= 1


def _sorted_case(n, g, k, r, s, tile, seed=5):
    """Rows with weight-0 rows among them, sorted into plan tiles, and S
    states; as numpy arrays for both packages."""
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=r, seed=seed)
    w = ds.weights.copy()
    w[::7] = 0.0
    plan = em_rsorted.rating_sort_pad(ds.ratings, r, tile=tile)
    trip, rat, w = em_rsorted.apply_rating_sort(plan, ds.triplets, ds.ratings, w)
    st = init_state(g, k, r, samples=s, seed=seed + 1)
    return trip, rat, w, plan.tile_r, st


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("r", [2, 3])
def test_plain_version_matches_reference_kernel(s, k, r):
    """The port's K9 plain version against the JAX kernel in interpret
    mode: G = 40, plan tiles of 16 rows."""
    trip, rat, w, tile_r, st = _sorted_case(300, 40, k, r, s, tile=16)
    want = jrs.rsorted_em_ensemble_stats(
        jnp.asarray(st.theta.numpy()), jnp.asarray(st.p.numpy()),
        JBatch(triplets=jnp.asarray(trip), ratings=jnp.asarray(rat),
               weights=jnp.asarray(w), tile_rating=jnp.asarray(tile_r)),
        tile_b=16, interpret=True)
    got = em_rsorted.rsorted_em_ensemble_stats(
        st.theta, st.p, make_batch(trip, rat, w, "cpu", tile_rating=tile_r), tile_b=16)
    np.testing.assert_allclose(got.theta_hat.numpy(), np.asarray(want.theta_hat), atol=1e-4)
    np.testing.assert_allclose(got.p_hat.numpy(), np.asarray(want.p_hat), atol=1e-4)
    np.testing.assert_allclose(got.loglik.numpy(), np.asarray(want.loglik), rtol=1e-5)


def test_per_row_ratings_are_ignored_and_a_table_is_required():
    """Scrambled per-row ratings give the same stats (the tile table rules);
    no tile table, or one of another tile size, raises."""
    trip, rat, w, tile_r, st = _sorted_case(300, 40, 4, 3, 2, tile=16)
    batch = make_batch(trip, rat, w, "cpu", tile_rating=tile_r)
    scrambled = batch._replace(ratings=torch.flip(batch.ratings, (0,)) * 7 - 3)
    a = em_rsorted.rsorted_em_ensemble_stats(st.theta, st.p, batch, 16)
    b = em_rsorted.rsorted_em_ensemble_stats(st.theta, st.p, scrambled, 16)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the same sweep on the unsorted rows (weight-0 pad rows are inert)
    real = w > 0
    plain = em_bdr.em_ensemble_stats(st.theta, st.p,
                                     make_batch(trip[real], rat[real], w[real], "cpu"))
    for x, y in zip(a, plain):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="tile_rating"):
        em_rsorted.rsorted_em_ensemble_stats(st.theta, st.p, batch._replace(tile_rating=None))
    with pytest.raises(ValueError, match="tiles of 32 rows"):
        em_rsorted.rsorted_em_ensemble_stats(st.theta, st.p, batch, 32)


def test_sweep_plan_range():
    """K9's K range is 1..28 (one rating's slice of p[s] at an 8-row tile);
    its kernel tile always divides the plan tile."""
    assert em_rsorted.MAX_K == 28
    assert em_rsorted.sweep_plan(28, 512) == (8, em_bdr.tile_smem_bytes(28, 1, 8))
    assert em_rsorted.sweep_plan(29, 512) is None and em_rsorted.sweep_plan(0, 512) is None
    assert em_rsorted.sweep_plan(10, 16)[0] == 16
    assert em_rsorted.sweep_plan(10, 4) is None  # no kernel tile divides 4
    for k in range(1, 29):
        tile, smem = em_rsorted.sweep_plan(k, 512)
        assert 512 % tile == 0 and smem <= em_bdr.SMEM_LIMIT


def _reference_stats_fn(tile_b):
    """The reference's kernel as its trainer's stats_fn override, tagged as
    its dispatch tags a rating-sorted kernel (the tags of its
    ``_pallas_bdr_fn``, less the kernel name)."""
    fn = functools.partial(jrs.rsorted_em_ensemble_stats, tile_b=tile_b, interpret=True)
    tags = vars(jdispatch._pallas_bdr_fn(tile_b))
    fn.__dict__.update({name: v for name, v in tags.items() if name != "kernel_name"})
    return fn


def _init(ds, k=3, s=2, seed=3):
    st = init_state(ds.n_genes, k, ds.n_ratings, samples=s, seed=seed)
    return st, JState(theta=st.theta.numpy(), p=st.p.numpy())


def test_classic_fit_matches_reference(tmp_path):
    """fit(stats_fn=em_rsorted.stats_fn(64)) against the reference's fit
    through its tagged kernel, from shared initial states: the L trace,
    final L and states; the split is sorted once and logged."""
    ds, _, _ = sample_synthetic_dataset(1000, 40, 3, n_ratings=3, seed=8)
    cfg = Config(train=TrainConfig(k=3, sweeps=8, samples=2, likelihood_freq=2, seed=1))
    tinit, jinit = _init(ds)
    jres = jfit(cfg, ds, logger=QUIET, init_states=jinit, stats_fn=_reference_stats_fn(64))
    events = str(tmp_path / "events.jsonl")
    with JsonlLogger(events, echo=False) as log:
        tres = fit(cfg, ds, device="cpu", logger=log, init_states=tinit,
                   stats_fn=em_rsorted.stats_fn(64))
    np.testing.assert_allclose(tres.ll_trace, jres.ll_trace, rtol=1e-4)
    np.testing.assert_allclose(tres.final_loglik, jres.final_loglik, rtol=1e-4)
    np.testing.assert_allclose(tres.states.theta.numpy(), np.asarray(jres.states.theta),
                               atol=1e-4)
    np.testing.assert_allclose(tres.states.p.numpy(), np.asarray(jres.states.p), atol=1e-4)
    assert tres.dispatch["kernel"] == em_rsorted.KERNEL_NAME
    assert tres.dispatch["tile_b"] == jres.dispatch["tile_b"] == 64
    recs = [json.loads(line) for line in open(events)]
    backend = next(r for r in recs if r["event"] == "backend")
    want_rows = em_rsorted.rating_sort_pad(ds.ratings, 3, tile=64).n_rows
    assert backend["padded_rows"] == want_rows and backend["tile_b"] == 64


def _stepwise_cfg(**train):
    base = dict(k=3, sweeps=3, samples=2, minibatch=256, likelihood_freq=1, seed=7)
    base.update(train)
    return Config(train=TrainConfig(**base),
                  engine=EngineConfig(backend="jnp", batch_pad_multiple=256))


def test_stepwise_fit_matches_reference():
    """Stepwise EM through the rating-sorted sweep: every minibatch sorted
    into ft = mb / tile + R tiles, against the reference's stepwise fit
    through its kernel; one group per epoch and groups of two agree."""
    ds, _, _ = sample_synthetic_dataset(2000, 24, 3, n_ratings=2, seed=2)
    tinit, jinit = _init(ds)
    jres = jfit(_stepwise_cfg(), ds, logger=QUIET, init_states=jinit,
                stats_fn=_reference_stats_fn(64))
    runs = [fit(_stepwise_cfg(stream_groups=g), ds, device="cpu", logger=QUIET,
                init_states=tinit, stats_fn=em_rsorted.stats_fn(64)) for g in (0, 2)]
    for tres in runs:
        np.testing.assert_allclose(tres.states.theta.numpy(), np.asarray(jres.states.theta),
                                   atol=2e-3)
        np.testing.assert_allclose(tres.states.p.numpy(), np.asarray(jres.states.p),
                                   atol=2e-3)
        np.testing.assert_allclose(tres.ll_trace, jres.ll_trace, rtol=1e-4)
        assert tres.layout["rsort_padded_mb"] == (256 // 64 + 2) * 64
        assert tres.dispatch["tile_b"] == 64
    mono, grouped = runs
    assert grouped.layout["stream_groups"] == 2
    np.testing.assert_allclose(grouped.states.theta.numpy(), mono.states.theta.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(grouped.ll_trace, mono.ll_trace, rtol=1e-5)


def test_stepwise_refuses_a_tile_it_cannot_use():
    """A rating-sorted route without a whole tile (``stats_fn(0)``) is
    refused where it is made, and a tile_b that does not divide the padded
    minibatch where the fit starts: both raise ValueError."""
    ds, _, _ = sample_synthetic_dataset(2000, 24, 3, n_ratings=2, seed=2)
    for untiled in (0, -64):
        with pytest.raises(ValueError, match="at least one row"):
            em_rsorted.stats_fn(untiled)
    with pytest.raises(ValueError, match="does not divide the padded minibatch"):
        fit(_stepwise_cfg(), ds, device="cpu", logger=QUIET, stats_fn=em_rsorted.stats_fn(96))

