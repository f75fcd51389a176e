"""Stepwise / streaming EM in the port against the JAX reference, on the CPU.

Both packages get the same numpy-seeded data and the same initial arrays
(their random draws differ by design).  Tolerances: the epoch update and
the whole fit follow the reference's float32 arithmetic step for step, so
the L trace and final L are held at rtol 1e-4 and theta at atol 1e-4 (the
fit tolerances of tests/test_backend_dispatch.py:120-125); the host prep
is bit-equal.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trigenicinteractionpredictor_tpu.config import Config, EngineConfig, TrainConfig
from trigenicinteractionpredictor_tpu.data.packing import TripletDataset as JDataset
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState as JState
from trigenicinteractionpredictor_tpu.ops.em import Batch as JBatch
from trigenicinteractionpredictor_tpu.ops.em import SweepStats as JStats
from trigenicinteractionpredictor_tpu.parallel.mesh import make_mesh
from trigenicinteractionpredictor_tpu.parallel.sharded_em import make_sharded_stepwise_epoch
from trigenicinteractionpredictor_tpu.train import stream_prep as jprep
from trigenicinteractionpredictor_tpu.train.checkpoint import save_checkpoint as jsave
from trigenicinteractionpredictor_tpu.train.trainer import fit as jfit
from trigenicinteractionpredictor_tpu.utils.logging import JsonlLogger
from trigenicinteractionpredictor_tpu_torch.data import TripletDataset
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu_torch.ops import dispatch, em_bdg
from trigenicinteractionpredictor_tpu_torch.ops.em import Batch, SweepStats
from trigenicinteractionpredictor_tpu_torch.ops.stepwise import stepwise_group, zero_stats_like
from trigenicinteractionpredictor_tpu_torch.train import stream_prep, trainer
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_RTOL = 1e-4
THETA_ATOL = 1e-4
QUIET = JsonlLogger(None, echo=False)


def _cfg(**train):
    base = dict(k=3, sweeps=3, samples=2, minibatch=256, likelihood_freq=1, seed=7)
    base.update(train)
    return Config(train=TrainConfig(**base),
                  engine=EngineConfig(backend="jnp", batch_pad_multiple=256))


def _data(n=2000, g=24, arity=3, seed=2):
    ds, _, _ = sample_synthetic_dataset(n, g, 3, n_ratings=2, seed=seed, arity=arity)
    return ds


def _init(ds, k=3, s=2, seed=3):
    st = init_state(ds.n_genes, k, ds.n_ratings, arity=ds.arity, samples=s, seed=seed)
    th, p = st.numpy()
    return st, JState(theta=th, p=p)


def _assert_fit_equal(tres, jres):
    assert tres.sweeps_run == jres.sweeps_run
    assert tres.ll_trace.shape == jres.ll_trace.shape
    np.testing.assert_allclose(tres.ll_trace, jres.ll_trace, rtol=FIT_RTOL)
    np.testing.assert_allclose(tres.final_loglik, jres.final_loglik, rtol=FIT_RTOL)
    np.testing.assert_allclose(tres.states.theta.numpy(), np.asarray(jres.states.theta),
                               atol=THETA_ATOL)
    np.testing.assert_allclose(tres.states.p.numpy(), np.asarray(jres.states.p),
                               atol=THETA_ATOL)


@pytest.mark.parametrize("fresh", [True, False])
def test_epoch_update_matches_reference(fresh):
    """ops/stepwise.py's group update equals make_sharded_stepwise_epoch on
    a one-device CPU mesh: same states, EMA and t in, same outputs."""
    ds = _data(1024, 20)
    n_mb, mb = 4, 256
    st, jst = _init(ds)
    rng = np.random.default_rng(0)
    if fresh:
        ema = zero_stats_like(st)
        t0 = 0.0
    else:
        ema = SweepStats(*(torch.as_tensor(rng.random(x.shape, dtype=np.float32) * 50)
                           for x in (st.theta, st.p, st.theta[:, 0, 0])))
        t0 = 5.0
    w = ds.weights.copy()
    w[::5] = 0.0
    trip = ds.triplets.reshape(n_mb, mb, 3)
    rat, wts = ds.ratings.reshape(n_mb, mb), w.reshape(n_mb, mb)
    deg = ds.degrees()
    w_total = np.float32(w.sum())

    step = make_sharded_stepwise_epoch(make_mesh(data=1, ensemble=1), n_mb, kappa=0.6, t0=2.0)
    j_states, j_ema, j_ll, j_t = step(
        JState(jnp.asarray(jst.theta), jnp.asarray(jst.p)),
        JStats(*(jnp.asarray(x.numpy()) for x in ema)), jnp.asarray(np.float32(t0)),
        JBatch(triplets=jnp.asarray(trip), ratings=jnp.asarray(rat), weights=jnp.asarray(wts)),
        jnp.asarray(deg), jnp.asarray(w_total),
    )
    states, ema2, ll, t = stepwise_group(
        st, ema, torch.tensor(t0, dtype=torch.float32),
        Batch(torch.as_tensor(trip), torch.as_tensor(rat), torch.as_tensor(wts)),
        torch.as_tensor(deg), torch.tensor(w_total), dispatch.plain_stats,
        kappa=0.6, t0=2.0,
    )
    assert float(t) == float(j_t) == t0 + n_mb
    np.testing.assert_allclose(states.theta.numpy(), np.asarray(j_states.theta), atol=1e-6)
    np.testing.assert_allclose(states.p.numpy(), np.asarray(j_states.p), atol=1e-6)
    for a, b in zip(ema2, j_ema):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ll.numpy(), np.asarray(j_ll), rtol=1e-5)


@pytest.mark.parametrize(
    "arity,train_kw",
    [
        (3, {"stream_groups": 0}),
        (3, {"stream_groups": 2}),
        (3, {"stream_groups": 2, "stream_prefetch": False}),
        (3, {"stream_groups": 0, "stream_prefetch": False}),
        (2, {"stream_groups": 0}),                          # digenic family
        (2, {"stream_groups": 2, "stream_prefetch": False}),
        (3, {"stream_groups": 3, "sweeps": 6, "tol": 1e9}),  # 8 minibatches -> groups of 2
    ],
)
def test_stepwise_fit_matches_reference(arity, train_kw):
    """3 epochs from the same initial state: the L trace, the final L and
    the states; stream groups, prefetch and arity do not change them."""
    ds = _data(arity=arity)
    cfg = _cfg(**train_kw)
    tinit, jinit = _init(ds)
    jres = jfit(cfg, ds, logger=QUIET, init_states=jinit)
    tres = fit(cfg, ds, device="cpu", logger=QUIET, init_states=tinit)
    _assert_fit_equal(tres, jres)
    groups = 2 if train_kw.get("stream_groups") in (2, 3) else 0
    assert tres.layout == {"minibatch": 256, "n_minibatches": 8, "stream_groups": groups,
                           "padded_rows": 2048, "prep_workers": 1, "rsort_padded_mb": 0}
    if "tol" in train_kw:
        assert tres.sweeps_run == 2 < cfg.train.sweeps


@pytest.mark.parametrize("seed,epoch,n", [(0, 0, 1000), (3, 5, 2048), (11, 2, 131_072)])
def test_epoch_perm_is_bit_equal(seed, epoch, n):
    got = stream_prep.epoch_perm(seed, epoch, n)
    want = jprep.epoch_perm(seed, epoch, n)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _layout(n, mb, group, seed=11):
    return {"seed": seed, "n": n, "n_padded": -(-n // mb) * mb, "mb": mb, "mb_b": mb,
            "group": group, "arity": 3, "rsort": False, "n_ratings": 2, "tile": 0,
            "n_shards": 1, "n_tiles": 0}


def _raw(n=700, g=30, seed=2):
    rng = np.random.default_rng(seed)
    return TripletDataset(
        triplets=rng.integers(0, g, size=(n, 3), dtype=np.int32),
        ratings=rng.integers(0, 2, size=n, dtype=np.int32),
        weights=rng.random(n).astype(np.float32),
        n_genes=g, n_ratings=2,
    )


def test_group_prep_is_bit_equal_to_reference():
    """The non-rsort group prep of the port equals the reference's
    StreamPrep (in-thread) for every group of two epochs, padding rows
    included."""
    ds = _raw()
    lay = _layout(ds.n_rows, 128, 2)
    jds = JDataset(ds.triplets, ds.ratings, ds.weights, ds.n_genes, ds.n_ratings)
    ref = jprep.StreamPrep(jds, lay, workers=1)
    ours = stream_prep.StreamPrep(ds, lay, workers=1)
    try:
        for ep in (0, 3):
            for d in range(lay["n_padded"] // (2 * 128)):
                a, b = ref.prep_group(ep, d), ours.prep_group(ep, d)
                for key in ("trip", "rat", "wts"):
                    np.testing.assert_array_equal(np.asarray(a[key]), b[key])
    finally:
        ref.close()
        ours.close()


def test_pool_prep_equals_in_thread_prep(tmp_path):
    """Two spawn workers reading a memmapped store write the same groups
    the in-thread path gathers; close() unlinks the shared memory, even
    while the caller still holds a view of it."""
    from multiprocessing import shared_memory

    ds = _raw(1000)
    ds.save_dir(str(tmp_path / "store"))
    store = TripletDataset.load_dir(str(tmp_path / "store"), mmap=True)
    lay = _layout(ds.n_rows, 128, 4)
    ref = stream_prep.StreamPrep(ds, lay, workers=1)
    pool = stream_prep.StreamPrep(store, lay, workers=2)
    try:
        assert pool.workers == 2 and pool.pool_error is None
        assert pool._ds_ref()[0] == "mmap"
        for ep, d in [(0, 0), (0, 1), (1, 0), (1, 1)]:
            a, b = ref.prep_group(ep, d), pool.prep_group(ep, d)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{key} {ep} {d}")
        held = b["trip"]
        names = [shm.name for slot in pool._slots for shm, _ in slot.values()]
    finally:
        ref.close()
        pool.close()
    assert held.shape == (4, 128, 3)
    for name in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)


@pytest.mark.parametrize("workers", [1, 2])
def test_rating_sort_group_prep_is_bit_equal_to_reference(tmp_path, workers):
    """The rsort group prep (every minibatch rating-sorted into ft = mb /
    tile + R tiles) equals the reference's StreamPrep for every group of
    two epochs, tile tables included: on the calling thread, and through
    two spawn workers over a memmapped store."""
    rng = np.random.default_rng(4)
    ds = _raw(1000)
    ds = TripletDataset(ds.triplets, rng.integers(0, 3, size=1000, dtype=np.int32),
                        ds.weights, ds.n_genes, n_ratings=3)
    ds.save_dir(str(tmp_path / "store"))
    store = TripletDataset.load_dir(str(tmp_path / "store"), mmap=True)
    mb, tile, ft = 128, 32, 128 // 32 + 3
    lay = dict(_layout(ds.n_rows, mb, 2), rsort=True, n_ratings=3, tile=tile, n_tiles=ft,
               mb_b=ft * tile)
    jds = JDataset(ds.triplets, ds.ratings, ds.weights, ds.n_genes, ds.n_ratings)
    ref = jprep.StreamPrep(jds, lay, workers=1)
    ours = stream_prep.StreamPrep(store if workers > 1 else ds, lay, workers=workers)
    try:
        assert ours.workers == workers and ours.pool_error is None
        for ep in (0, 3):
            for d in range(lay["n_padded"] // (2 * mb)):
                a, b = ref.prep_group(ep, d), ours.prep_group(ep, d)
                assert sorted(b) == ["rat", "tiler", "trip", "wts"]
                assert b["trip"].shape == (2, ft * tile, 3) and b["tiler"].shape == (2, ft)
                for key in b:
                    np.testing.assert_array_equal(np.asarray(a[key]), b[key],
                                                  err_msg=f"{key} {ep} {d}")
    finally:
        ref.close()
        ours.close()


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A stepwise checkpoint the reference writes (EMA carry in ``extra``)
    resumes in the port to the epochs the reference's own resume gives,
    and a port checkpoint resumes in the reference the same way."""
    ds = _data()
    tinit, jinit = _init(ds)
    jck = str(tmp_path / "jax.npz")
    jfit(_cfg(sweeps=2), ds, logger=QUIET, init_states=jinit, checkpoint_path=jck)
    j_resumed = jfit(_cfg(sweeps=4), ds, logger=QUIET, resume=jck)
    t_resumed = fit(_cfg(sweeps=4), ds, device="cpu", logger=QUIET, resume=jck)
    _assert_fit_equal(t_resumed, j_resumed)

    tck = str(tmp_path / "port.npz")
    fit(_cfg(sweeps=2), ds, device="cpu", logger=QUIET, init_states=tinit, checkpoint_path=tck)
    _assert_fit_equal(fit(_cfg(sweeps=4), ds, device="cpu", logger=QUIET, resume=tck),
                      jfit(_cfg(sweeps=4), ds, logger=QUIET, resume=tck))


def test_port_resume_equals_fit_from_scratch(tmp_path):
    """fit(6) == fit(3) + resume -> 6 in the port: the checkpoint carries
    the EMA statistics and the update counter, and the shuffle is (seed,
    epoch)-derived (the counterpart of tests/test_stepwise.py:157-186)."""
    ds = _data(2048, 16)
    cfg = lambda sweeps: _cfg(sweeps=sweeps, seed=5)  # noqa: E731
    full = fit(cfg(6), ds, device="cpu", logger=QUIET)
    ck = str(tmp_path / "sw.ckpt.npz")
    fit(cfg(3), ds, device="cpu", logger=QUIET, checkpoint_path=ck)
    resumed = fit(cfg(6), ds, device="cpu", logger=QUIET, resume=ck, checkpoint_path=ck)
    assert resumed.sweeps_run == 6 and resumed.ll_trace.shape[0] == 6
    np.testing.assert_allclose(resumed.states.theta.numpy(), full.states.theta.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(resumed.final_loglik, full.final_loglik, rtol=1e-6)
    np.testing.assert_allclose(resumed.ll_trace, full.ll_trace, rtol=1e-6)


def test_checkpoint_without_carry_restarts_from_scratch(tmp_path):
    """A checkpoint with no EMA carry starts the stepwise fit afresh rather
    than raising (tests/test_stepwise.py:124-143)."""
    ds = _data(1024, 16)
    ck = str(tmp_path / "prev.npz")
    st, _ = _init(ds, s=1)
    jsave(ck, JState(theta=st.theta.numpy(), p=st.p.numpy()), sweep=2,
          ll_trace=np.zeros((0, 1)))
    events = str(tmp_path / "events.jsonl")
    with JsonlLogger(events, echo=False) as log:
        result = fit(_cfg(sweeps=4, samples=1), ds, device="cpu", logger=log, resume=ck)
    assert result.sweeps_run == 4 and np.isfinite(result.final_loglik).all()
    names = [json.loads(line)["event"] for line in open(events)]
    assert "stepwise_restart" in names


def test_minibatch_rounds_up_not_lcm():
    """minibatch=1000 with pad 512 gives 1024-row minibatches
    (tests/test_stepwise.py:146-154); one minibatch is refused."""
    ds = _data(8192, 20)
    cfg = Config(train=TrainConfig(k=2, sweeps=2, samples=1, minibatch=1000))
    result = fit(cfg, ds, device="cpu", logger=QUIET)
    assert result.sweeps_run == 2 and result.layout["minibatch"] == 1024
    with pytest.raises(ValueError, match="classic EM"):
        fit(Config(train=TrainConfig(k=2, sweeps=1, minibatch=8192)), ds, device="cpu",
            logger=QUIET)


def test_streamed_fit_residency_is_group_bounded(tmp_path, monkeypatch):
    """From a memmapped store: the stats function never sees more than one
    minibatch, no group on the device exceeds group * mb rows, the final
    L reads windows of one group, and the dataset is never padded whole
    (the counterpart of tests/test_streaming.py:63)."""
    N, mb, groups = 8192, 256, 2
    _data(N, 32, seed=3).save_dir(str(tmp_path / "big"))
    store = TripletDataset.load_dir(str(tmp_path / "big"), mmap=True)

    def no_pad(self, multiple):
        raise AssertionError("pad_to() materializes the whole dataset")

    monkeypatch.setattr(TripletDataset, "pad_to", no_pad)
    seen = {"stats": 0, "group": 0, "window": 0}
    real_put, real_batch = trainer._GroupStager.put, trainer.make_batch

    def stats(thetas, ps, batch):
        seen["stats"] = max(seen["stats"], batch.triplets.shape[0])
        return dispatch.plain_stats(thetas, ps, batch)

    def put(self, host):
        seen["group"] = max(seen["group"], host["trip"].shape[0] * host["trip"].shape[1])
        return real_put(self, host)

    def window(trip, *a, **k):
        seen["window"] = max(seen["window"], len(trip))
        return real_batch(trip, *a, **k)

    monkeypatch.setattr(trainer._GroupStager, "put", put)
    monkeypatch.setattr(trainer, "make_batch", window)
    cfg = _cfg(sweeps=3, minibatch=mb, stream_groups=groups, seed=4)
    result = fit(cfg, store, device="cpu", logger=QUIET, stats_fn=stats)
    assert np.isfinite(result.final_loglik).all()
    assert seen == {"stats": mb, "group": groups * mb, "window": groups * mb}


def test_streamed_fit_from_memmap_store_with_pool(tmp_path):
    """A memmapped store through two spawn prep workers gives the fit the
    in-memory dataset gives in-thread."""
    ds = _data(8192, 32, seed=5)
    ds.save_dir(str(tmp_path / "big"))
    store = TripletDataset.load_dir(str(tmp_path / "big"), mmap=True)
    tinit, _ = _init(ds)
    pooled = fit(_cfg(sweeps=2, stream_groups=2, stream_prep_workers=2), store,
                 device="cpu", logger=QUIET, init_states=tinit)
    inline = fit(_cfg(sweeps=2, stream_groups=2, stream_prep_workers=1), ds,
                 device="cpu", logger=QUIET, init_states=tinit)
    assert pooled.layout["prep_workers"] == 2
    np.testing.assert_array_equal(pooled.states.theta.numpy(), inline.states.theta.numpy())
    np.testing.assert_array_equal(pooled.final_loglik, inline.final_loglik)


def test_plan_route_under_stepwise_runs_the_plain_sweep(tmp_path):
    """A plan-route stats_fn passed in with minibatch > 0 gives the plain
    sweep and a ``backend`` event (the reference's trainer.py:228-236)."""
    ds = _data()
    events = str(tmp_path / "events.jsonl")
    with JsonlLogger(events, echo=False) as log:
        res = fit(_cfg(sweeps=1), ds, device="cpu", logger=log,
                  stats_fn=dispatch.stats_fn_for(em_bdg.KERNEL_NAME, 3, 2))
    assert res.dispatch["kernel"] == dispatch.PLAIN_NAME
    recs = [json.loads(line) for line in open(events)]
    assert any(r["event"] == "backend" and r.get("reason") == "static row order vs stepwise"
               for r in recs)


def test_cli_fit_minibatch(tmp_path, capsys):
    """``fit --minibatch`` through the port's CLI on the CPU: the route and
    the stepwise layout are printed, the report and checkpoint written."""
    from trigenicinteractionpredictor_tpu_torch.cli import main

    data = str(tmp_path / "d.npz")
    assert main(["synth", "-o", data, "-n", "3000", "-g", "40", "-k", "3"]) == 0
    out = str(tmp_path / "run")
    assert main(["fit", "-f", data, "-k", "3", "-i", "3", "-s", "2", "-n", "1", "-o", out,
                 "--device", "cpu", "--minibatch", "512", "--stream-groups", "2",
                 "--no-stream-prefetch"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    route = next(x for x in lines if "route" in x)
    assert route == {"route": dispatch.PLAIN_NAME,
                     "stepwise": {"minibatch": 512, "n_minibatches": 5, "stream_groups": 1,
                                  "padded_rows": 2560, "prep_workers": 1,
                                  "rsort_padded_mb": 0}}
    report = json.load(open(os.path.join(out, "report.json")))
    assert report["sweeps"] == 3 and np.isfinite(report["ll_best"])
    events = [json.loads(x) for x in open(os.path.join(out, "events.jsonl"))]
    assert next(e for e in events if e["event"] == "fit_done")["mode"] == "stepwise"


@pytest.mark.parametrize("route", ["cuda-em-sweep", "cuda-em-sweep-large-k", "cuda-em-hybrid"])
def test_stream_groups_do_not_change_the_fit(route):
    """Through each kernel route's stats function (its plain version on the
    CPU), one group per epoch and groups of two give the same fit: the EMA
    sequence depends only on the counter and the per-minibatch sums (the
    counterpart of tests/test_stepwise.py:251-277)."""
    k = 3 if route == "cuda-em-sweep" else 21
    ds = _data(1500, 30)
    tinit, _ = _init(ds, k=k)
    fn = dispatch.stats_fn_for(route, k, 2)
    mono = fit(_cfg(k=k, sweeps=2), ds, device="cpu", logger=QUIET, init_states=tinit,
               stats_fn=fn)
    grouped = fit(_cfg(k=k, sweeps=2, stream_groups=2), ds, device="cpu", logger=QUIET,
                  init_states=tinit, stats_fn=fn)
    assert mono.dispatch["kernel"] == route and grouped.layout["stream_groups"] == 2
    np.testing.assert_allclose(grouped.states.theta.numpy(), mono.states.theta.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(grouped.states.p.numpy(), mono.states.p.numpy(), atol=1e-6)
    np.testing.assert_allclose(grouped.ll_trace, mono.ll_trace, rtol=1e-6)
