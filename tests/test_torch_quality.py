"""The fit's quality knobs in the port against the JAX reference, on the CPU:
DAEM annealing, the spectral init, split-merge (smem) and perturb-and-
resweep (refine) rounds, and the numpy pieces they rest on.

Both packages get the same numpy-seeded data and, where the knob does not
make its own, the same initial arrays.  Tolerances: the numpy pieces
(``_anneal_schedule``, ``merge_split_candidate``, ``spectral_init_arrays``)
are bit-equal; a fit is held to the reference's kernel-vs-jnp fit
tolerances (tests/test_backend_dispatch.py:120-125): the L trace, the final
L and the rounds' L events rtol 1e-4, theta and p atol 1e-4.  The rounds'
cases use seeds whose accepted lanes win by far more than that.
"""

import json
import os

import numpy as np
import pytest
import torch

from trigenicinteractionpredictor_tpu.config import Config as JConfig
from trigenicinteractionpredictor_tpu.config import EngineConfig as JEngine
from trigenicinteractionpredictor_tpu.config import TrainConfig as JTrain
from trigenicinteractionpredictor_tpu.data.splits import train_test_split as jsplit
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset as jsynth
from trigenicinteractionpredictor_tpu.models import informed_init as jinit
from trigenicinteractionpredictor_tpu.models.mmsbm import ModelState as JState
from trigenicinteractionpredictor_tpu.models.proposals import merge_split_candidate as jmsc
from trigenicinteractionpredictor_tpu.train import checkpoint as jckpt
from trigenicinteractionpredictor_tpu.train.trainer import _anneal_schedule as janneal
from trigenicinteractionpredictor_tpu.train.trainer import fit as jfit
from trigenicinteractionpredictor_tpu_torch.config import Config, EngineConfig, TrainConfig
from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset, train_test_split
from trigenicinteractionpredictor_tpu_torch.models import informed_init
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
from trigenicinteractionpredictor_tpu_torch.models.proposals import merge_split_candidate
from trigenicinteractionpredictor_tpu_torch.ops import dispatch
from trigenicinteractionpredictor_tpu_torch.train.trainer import _anneal_schedule, fit
from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_RTOL = 1e-4     # reference tests/test_backend_dispatch.py:120-122
THETA_ATOL = 1e-4   # reference tests/test_backend_dispatch.py:123-125
QUIET = JsonlLogger(None, echo=False)
ROUND_EVENTS = ("smem", "smem_done", "smem_skipped", "refine", "refine_done",
                "refine_skipped", "anneal", "init")


class Events:
    """A logger that keeps every event, for both packages' fits."""

    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))

    def rounds(self):
        return [(e, f) for e, f in self.events if e in ROUND_EVENTS]


def _data(n=1500, g=30, k=4, seed=0, alpha=0.1, arity=3):
    """The same 80% train split from both packages' generators."""
    kw = dict(n_ratings=2, alpha_theta=alpha, seed=seed, arity=arity)
    return (jsplit(jsynth(n, g, k, **kw)[0], 0.2, 0)[0],
            train_test_split(sample_synthetic_dataset(n, g, k, **kw)[0], 0.2, 0)[0])


def _cfgs(**train):
    """(reference Config, port Config) with the same training knobs, on
    the plain sweep."""
    base = dict(k=3, sweeps=24, samples=2, likelihood_freq=4, seed=2)
    base.update(train)
    return (JConfig(train=JTrain(**base), engine=JEngine(backend="jnp")),
            Config(train=TrainConfig(**base), engine=EngineConfig(backend="jnp")))


def _init(ds, k, s, seed=3):
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


def _assert_rounds_equal(tev, jev):
    """The knobs' events agree: names, rounds, moves, and L within rtol."""
    got, want = tev.rounds(), jev.rounds()
    print("port:", got)
    print("reference:", want)
    assert [e for e, _ in got] == [e for e, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.keys() >= w.keys()
        for key, val in w.items():
            if key in ("from_ll", "to_ll"):
                np.testing.assert_allclose(g[key], val, rtol=FIT_RTOL, err_msg=key)
            else:
                assert g[key] == val, (key, g[key], val)


# ---------------------------------------------------------------------------
# DAEM annealing


@pytest.mark.parametrize("train", [
    dict(sweeps=100, anneal_beta0=0.25, anneal_sweeps=40),
    dict(sweeps=50, anneal_beta0=0.3),                       # ramp: half the budget
    dict(sweeps=7, anneal_beta0=0.1, anneal_sweeps=20),      # ramp past the budget
    dict(sweeps=1, anneal_beta0=0.5),
    dict(sweeps=12, anneal_beta0=1.0 - 1e-6, anneal_sweeps=1),
    dict(sweeps=30, anneal_beta0=1.0),                       # off
])
def test_anneal_schedule_equals_reference(train):
    want = janneal(JTrain(**train))
    got = _anneal_schedule(TrainConfig(**train))
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arity,train,sweeps_run", [
    (3, dict(anneal_beta0=0.3, anneal_sweeps=10), 24),
    (2, dict(anneal_beta0=0.3, anneal_sweeps=10), 24),       # digenic family
    # |dL| < tol at every check: no stop inside the ramp (it ends at 24), the
    # first at the check of 32 = 24 + 2 freq, one check late
    (3, dict(sweeps=40, anneal_beta0=0.3, anneal_sweeps=24, tol=1e9), 36),
    # a short ramp: the stop after it, as without annealing but 2 freq later
    (3, dict(sweeps=40, anneal_beta0=0.2, anneal_sweeps=6, tol=1e9), 20),
])
def test_annealed_fit_matches_reference(arity, train, sweeps_run):
    jtrain, ttrain = _data(n=1200, g=30, k=3, seed=4, alpha=0.3, arity=arity)
    jcfg, tcfg = _cfgs(**train)
    tinit, jinit_ = _init(ttrain, 3, 2)
    jev, tev = Events(), Events()
    jres = jfit(jcfg, jtrain, logger=jev, init_states=jinit_)
    tres = fit(tcfg, ttrain, device="cpu", logger=tev, init_states=tinit)
    _assert_fit_equal(tres, jres)
    _assert_rounds_equal(tev, jev)
    assert tres.sweeps_run == sweeps_run
    assert ("early_stop" in [e for e, _ in tev.events]) == ("tol" in train)


def test_annealed_resume_mid_ramp_continues_the_ramp(tmp_path):
    """A checkpoint at sweep 6 of a 16-sweep ramp resumes on the ramp's
    sweep-6 beta: the resumed fit lands where the straight one does, in the
    port and in the reference resuming the same checkpoint."""
    jtrain, ttrain = _data(n=1200, g=30, k=3, seed=4, alpha=0.3)
    knobs = dict(anneal_beta0=0.3, anneal_sweeps=16)
    tinit, _ = _init(ttrain, 3, 2)
    _, straight_cfg = _cfgs(**knobs)
    straight = fit(straight_cfg, ttrain, device="cpu", logger=QUIET, init_states=tinit)
    half = str(tmp_path / "half.npz")
    fit(_cfgs(sweeps=6, checkpoint_every=6, **knobs)[1], ttrain, device="cpu", logger=QUIET,
        init_states=tinit, checkpoint_path=half)
    jcfg, tcfg = _cfgs(**knobs)
    resumed = fit(tcfg, ttrain, device="cpu", logger=QUIET, resume=half)
    jres = jfit(jcfg, jtrain, logger=QUIET, resume=half)
    _assert_fit_equal(resumed, jres)
    np.testing.assert_allclose(resumed.final_loglik, straight.final_loglik, rtol=1e-6)
    np.testing.assert_allclose(resumed.states.theta.numpy(), straight.states.theta.numpy(),
                               atol=1e-6)


def test_annealed_sweep_keeps_the_carry_for_untrained_genes():
    """normalize_from_stats keeps the old value where a gene has no
    training rows: in an annealed sweep that is the unpowered carry, not
    theta^beta, so the untrained genes' rows leave the fit as they came."""
    jtrain, ttrain = _data(n=1200, g=30, k=3, seed=4, alpha=0.3)
    for ds in (jtrain, ttrain):
        ds.n_genes = 34          # genes 30..33 have no rows
    jcfg, tcfg = _cfgs(anneal_beta0=0.2, anneal_sweeps=20)
    tinit, jinit_ = _init(ttrain, 3, 2)
    tres = fit(tcfg, ttrain, device="cpu", logger=QUIET, init_states=tinit)
    jres = jfit(jcfg, jtrain, logger=QUIET, init_states=jinit_)
    _assert_fit_equal(tres, jres)
    np.testing.assert_array_equal(tres.states.theta.numpy()[:, 30:],
                                  tinit.theta.numpy()[:, 30:])
    np.testing.assert_allclose(tres.states.theta.numpy().sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("route", ["cuda-em-bdg", "cuda-em-bd-plan", "cuda-em-large-g"])
def test_annealed_fit_through_plan_routes_equals_plain(route):
    """An annealed fit through each large-G route's stats function (its
    host plans built by the trainer; on the CPU the kernels' plain
    versions run through the plans) equals the plain-route annealed fit."""
    _, ttrain = _data(n=1500, g=400, k=4, seed=6, alpha=0.3)
    s = 1 if route == "cuda-em-large-g" else 2
    _, tcfg = _cfgs(k=4, samples=s, sweeps=16, anneal_beta0=0.3, anneal_sweeps=10)
    tinit, _ = _init(ttrain, 4, s)
    via_plan = fit(tcfg, ttrain, device="cpu", logger=QUIET, init_states=tinit,
                   stats_fn=dispatch.stats_fn_for(route, 4, 2))
    plain = fit(tcfg, ttrain, device="cpu", logger=QUIET, init_states=tinit,
                stats_fn=dispatch.plain_stats)
    assert via_plan.dispatch["kernel"] == route
    np.testing.assert_allclose(via_plan.ll_trace, plain.ll_trace, rtol=FIT_RTOL)
    np.testing.assert_allclose(via_plan.final_loglik, plain.final_loglik, rtol=FIT_RTOL)
    np.testing.assert_allclose(via_plan.states.theta.numpy(), plain.states.theta.numpy(),
                               atol=THETA_ATOL)


# ---------------------------------------------------------------------------
# The numpy pieces: bit-equal


@pytest.mark.parametrize("arity", [3, 2])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_merge_split_candidate_equals_reference(arity, seed):
    rng = np.random.default_rng(100 + seed)
    G, K, R = 25, 5, 2
    theta = rng.dirichlet(np.ones(K), size=G).astype(np.float32)
    p = rng.dirichlet(np.ones(R), size=(K,) * arity).astype(np.float32)
    if seed == 7:
        theta[:, 2:] = 0.0       # starved groups: the split's fallback draw
        theta[:, 0] = 0.5
        theta[:, 1] = 0.5
    draws_t, draws_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):           # consecutive proposals from one generator
        th, pp, move = merge_split_candidate(theta, p, draws_t)
        jth, jpp, jmove = jmsc(theta, p, draws_j)
        assert move == jmove
        assert th.dtype == jth.dtype and pp.dtype == jpp.dtype
        np.testing.assert_array_equal(th, jth)
        np.testing.assert_array_equal(pp, jpp)


@pytest.mark.parametrize("arity", [3, 2])
@pytest.mark.parametrize("seed,samples", [(0, 4), (5, 3), (2, 1)])
def test_spectral_init_arrays_equal_reference(arity, seed, samples):
    jtrain, ttrain = _data(n=1200, g=25, k=4, seed=8 + seed, arity=arity)
    th, pp = informed_init.spectral_init_arrays(ttrain, 4, samples, seed=seed)
    jth, jpp = jinit.spectral_init_arrays(jtrain, 4, samples, seed=seed)
    assert th.dtype == jth.dtype and pp.dtype == jpp.dtype
    np.testing.assert_array_equal(th, jth)
    np.testing.assert_array_equal(pp, jpp)


@pytest.mark.parametrize("minibatch", [0, 256])
def test_spectral_fit_matches_reference(minibatch):
    """No injected state: both packages seed from the spectral init of the
    same split, classic and stepwise, and log the ``init`` event."""
    jtrain, ttrain = _data(n=1500, g=30, k=3, seed=9, alpha=0.3)
    train = dict(init_method="spectral", samples=3)
    if minibatch:
        train.update(minibatch=minibatch, sweeps=3, likelihood_freq=1, seed=7)
    jcfg, tcfg = _cfgs(**train)
    if minibatch:  # the reference pads stepwise minibatches to this multiple
        jcfg = jcfg.replace(engine=JEngine(backend="jnp", batch_pad_multiple=256))
        tcfg = tcfg.replace(engine=EngineConfig(backend="jnp", batch_pad_multiple=256))
    jev, tev = Events(), Events()
    jres = jfit(jcfg, jtrain, logger=jev)
    tres = fit(tcfg, ttrain, device="cpu", logger=tev)
    _assert_fit_equal(tres, jres)
    _assert_rounds_equal(tev, jev)
    assert [e for e, _ in tev.events].count("init") == 1


# ---------------------------------------------------------------------------
# Split-merge and refine rounds


@pytest.mark.parametrize("knobs,arity,data_seed,seed", [
    (dict(refine_rounds=2, refine_sweeps=10), 3, 0, 2),      # accepted in round 0
    (dict(refine_rounds=2, refine_sweeps=10), 3, 0, 1),      # accepted in round 1
    (dict(smem_rounds=2, smem_sweeps=10), 3, 0, 0),          # a move in round 1
    (dict(smem_rounds=2, smem_sweeps=10), 2, 0, 0),          # digenic, round 0
    (dict(smem_rounds=2, smem_sweeps=10, refine_rounds=2, refine_sweeps=10), 3, 2, 1),
])
def test_rounds_match_reference(tmp_path, knobs, arity, data_seed, seed):
    """_smem, _refine and the two together against the reference from the
    same injected state: final states and L, every round's from_ll / to_ll
    and accepted move, and the final checkpoint's sweep and trace."""
    jtrain, ttrain = _data(n=1500, g=30, k=4, seed=data_seed, arity=arity)
    jcfg, tcfg = _cfgs(k=4, sweeps=10, samples=3, likelihood_freq=5, seed=seed, **knobs)
    tinit, jinit_ = _init(ttrain, 4, 3, seed=seed + 3)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    jev, tev = Events(), Events()
    jres = jfit(jcfg, jtrain, logger=jev, init_states=jinit_, checkpoint_path=jpath)
    tres = fit(tcfg, ttrain, device="cpu", logger=tev, init_states=tinit,
               checkpoint_path=tpath)
    _assert_fit_equal(tres, jres)
    _assert_rounds_equal(tev, jev)
    rounds = knobs.get("smem_rounds", 0) + knobs.get("refine_rounds", 0)
    assert tres.sweeps_run == 10 + 10 * rounds
    # the case is meaningful: some round accepted a lane by a clear margin
    done = [f["to_ll"] for e, f in tev.rounds() if e.endswith("_done")]
    assert done[-1] > tev.rounds()[0][1]["from_ll"] + 1.0
    tck, jck = jckpt.load_checkpoint(tpath), jckpt.load_checkpoint(jpath)
    assert tck["sweep"] == jck["sweep"] == tres.sweeps_run
    np.testing.assert_allclose(tck["ll_trace"], jck["ll_trace"], rtol=FIT_RTOL)
    np.testing.assert_allclose(tck["states"].theta, np.asarray(jres.states.theta),
                               atol=THETA_ATOL)


@pytest.mark.parametrize("knobs,k,s", [
    (dict(smem_rounds=1), 2, 3),      # split-merge needs K >= 3
    (dict(smem_rounds=1), 3, 1),      # and two lanes
    (dict(refine_rounds=1), 3, 1),    # refine needs two lanes
])
def test_rounds_skip_as_the_reference(knobs, k, s):
    jtrain, ttrain = _data(n=800, g=20, k=3, seed=3)
    jcfg, tcfg = _cfgs(k=k, samples=s, sweeps=8, **knobs)
    tinit, jinit_ = _init(ttrain, k, s)
    jev, tev = Events(), Events()
    jres = jfit(jcfg, jtrain, logger=jev, init_states=jinit_)
    tres = fit(tcfg, ttrain, device="cpu", logger=tev, init_states=tinit)
    _assert_fit_equal(tres, jres)
    _assert_rounds_equal(tev, jev)
    assert tres.sweeps_run == 8 and tev.rounds()[-1][0].endswith("_skipped")


# ---------------------------------------------------------------------------
# The CLI


def test_cli_fit_with_every_knob_matches_reference(tmp_path, monkeypatch):
    """``fit`` on the example TSV with all four knobs through both
    packages' CLIs: the spectral init makes the start the same, so the
    reports and the rounds' events agree."""
    from trigenicinteractionpredictor_tpu.cli import main as jmain
    from trigenicinteractionpredictor_tpu_torch.cli import main

    monkeypatch.setenv("TRIGENIC_TPU_COMPILE_CACHE", "")  # no cache outside the test
    tsv = os.path.join(REPO, "datasets", "example_trigenic.tsv")
    args = ["fit", "-f", tsv, "-k", "3", "-i", "20", "-s", "3", "-n", "5", "--backend", "jnp",
            "--init", "spectral", "--anneal-beta0", "0.3", "--anneal-sweeps", "8",
            "--smem-rounds", "1", "--smem-sweeps", "5", "--refine-rounds", "1",
            "--refine-sweeps", "5"]
    assert main(args + ["-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert jmain(args + ["-o", str(tmp_path / "j")]) == 0
    reports, events = {}, {}
    for side in ("t", "j"):
        with open(tmp_path / side / "report.json") as fh:
            reports[side] = json.load(fh)
        with open(tmp_path / side / "events.jsonl") as fh:
            events[side] = [json.loads(line) for line in fh]
    assert reports["t"]["sweeps"] == reports["j"]["sweeps"] == 30
    for key in ("ll_best", "heldout_loglik", "auc"):
        np.testing.assert_allclose(reports["t"][key], reports["j"][key], rtol=FIT_RTOL,
                                   err_msg=key)
    names = [[e["event"] for e in events[side] if e["event"] in ROUND_EVENTS]
             for side in ("t", "j")]
    assert names[0] == names[1] == ["init", "anneal", "smem", "smem_done", "refine",
                                    "refine_done"]


def test_cli_sweep_passes_the_knobs_to_every_unit(tmp_path):
    from trigenicinteractionpredictor_tpu_torch.cli import main

    tsv = os.path.join(REPO, "datasets", "example_trigenic.tsv")
    out = str(tmp_path / "sw")
    assert main(["sweep", "-f", tsv, "--k-grid", "2,3", "-i", "10", "-s", "2", "-n", "5",
                 "-o", out, "--device", "cpu", "--anneal-beta0", "0.5",
                 "--refine-rounds", "1", "--refine-sweeps", "4"]) == 0
    with open(os.path.join(out, "report.json")) as fh:
        units = json.load(fh)["units"]
    assert sorted(u["k"] for u in units) == [2, 3]
    assert all(u["sweeps"] == 14 for u in units)
    with open(os.path.join(out, "events_p0.jsonl")) as fh:
        names = [json.loads(line)["event"] for line in fh]
    assert names.count("anneal") == 2 and names.count("refine_done") == 2


# ---------------------------------------------------------------------------
# Ports of the reference's tests/test_quality_knobs.py, on the port


def _ds(n=2000, g=30, k=3, seed=0, alpha=0.3):
    ds, _, _ = sample_synthetic_dataset(n, g, k, alpha_theta=alpha, seed=seed)
    return train_test_split(ds, 0.2, 0)[0]


def _fit(train, **kw):
    return fit(Config(train=TrainConfig(**kw)), train, device="cpu", logger=QUIET)


def test_anneal_schedule_shape():
    t = TrainConfig(sweeps=100, anneal_beta0=0.25, anneal_sweeps=40)
    sched = _anneal_schedule(t)
    assert sched.shape == (100,)
    assert np.isclose(sched[0], 0.25, atol=1e-6)
    assert np.all(np.diff(sched) >= -1e-7)          # monotone ramp
    assert np.allclose(sched[40:], 1.0)             # exact EM after ramp
    assert _anneal_schedule(TrainConfig(anneal_beta0=1.0)) is None


def test_annealed_beta_one_equals_plain():
    """A beta == 1 'annealed' run reproduces plain EM: the powered-parameter
    trick is the identity at beta 1."""
    train = _ds()
    base = dict(k=3, sweeps=8, samples=2, likelihood_freq=4, seed=0)
    plain = _fit(train, **base)
    annealed = _fit(train, **base, anneal_beta0=1.0 - 1e-6, anneal_sweeps=1)
    np.testing.assert_allclose(annealed.final_loglik, plain.final_loglik, rtol=1e-5)


def test_annealed_run_monotone_after_ramp():
    train = _ds(seed=3)
    r = _fit(train, k=3, sweeps=30, samples=2, likelihood_freq=1, seed=1,
             anneal_beta0=0.3, anneal_sweeps=10)
    assert r.sweeps_run == 30
    np.testing.assert_allclose(r.states.theta.numpy().sum(-1), 1.0, atol=1e-5)
    # Post-ramp rows of the trace are exact-EM likelihoods: monotone.
    assert (np.diff(r.ll_trace[12:], axis=0) >= -1e-2).all()


def test_refinement_never_loses_likelihood():
    train = _ds(seed=5, alpha=0.1)
    base = dict(k=3, sweeps=40, samples=3, likelihood_freq=10, seed=2)
    plain = _fit(train, **base)
    refined = _fit(train, **base, refine_rounds=2, refine_sweeps=10)
    assert refined.final_loglik.max() >= plain.final_loglik.max() - 1e-3
    assert refined.sweeps_run == 40 + 2 * 10


def test_spectral_init_valid_simplexes():
    train = _ds(n=1500, g=25, k=4, seed=7)
    thetas, ps = informed_init.spectral_init_arrays(train, k=4, n_samples=5, seed=0)
    assert thetas.shape == (5, 25, 4)
    assert ps.shape == (5, 4, 4, 4, 2)
    np.testing.assert_allclose(thetas.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(ps.sum(-1), 1.0, atol=1e-5)
    assert (thetas >= 0).all() and (ps >= 0).all()
    # graded noise: later restarts are farther from restart 0's init
    d = [float(np.abs(thetas[s] - thetas[0]).mean()) for s in range(1, 5)]
    assert d == sorted(d)
    r = _fit(train, k=4, sweeps=10, samples=3, likelihood_freq=5, init_method="spectral")
    assert np.isfinite(r.final_loglik).all()


def test_merge_split_candidate_preserves_invariants():
    rng = np.random.default_rng(0)
    G, K, R = 25, 5, 2
    theta = rng.dirichlet(np.ones(K), size=G)
    p = rng.dirichlet(np.ones(R), size=(K, K, K))
    th2, p2, (j, k, split) = merge_split_candidate(theta, p, rng)
    assert th2.shape == (G, K) and p2.shape == (K, K, K, R)
    np.testing.assert_allclose(th2.sum(-1), 1.0, atol=1e-5)   # simplex rows
    np.testing.assert_allclose(p2.sum(-1), 1.0, atol=1e-5)
    assert (th2 >= 0).all() and (p2 >= 0).all()
    assert j != k and split not in (j, k)
    # the merge column carries the combined mass of its parents
    np.testing.assert_allclose(th2[:, 0], theta[:, j] + theta[:, k], atol=1e-6)
    # the split children partition the parent column per gene
    np.testing.assert_allclose(th2[:, 1] + th2[:, 2], theta[:, split], atol=1e-6)
    # digenic family: p[K, K, R] goes through the same axis map
    p_di = rng.dirichlet(np.ones(R), size=(K, K))
    _, p2_di, _ = merge_split_candidate(theta, p_di, rng)
    assert p2_di.shape == (K, K, R)
    np.testing.assert_allclose(p2_di.sum(-1), 1.0, atol=1e-5)


def test_smem_never_loses_likelihood():
    train = _ds(seed=9, alpha=0.1)
    base = dict(k=3, sweeps=40, samples=3, likelihood_freq=10, seed=2)
    plain = _fit(train, **base)
    smem = _fit(train, **base, smem_rounds=2, smem_sweeps=10)
    assert smem.final_loglik.max() >= plain.final_loglik.max() - 1e-3
    assert smem.sweeps_run == 40 + 2 * 10


def test_smem_composes_with_refine():
    train = _ds(seed=11)
    r = _fit(train, k=3, sweeps=20, samples=2, likelihood_freq=10, seed=1,
             smem_rounds=1, smem_sweeps=5, refine_rounds=1, refine_sweeps=5)
    assert r.sweeps_run == 20 + 5 + 5
    assert np.isfinite(r.final_loglik).all()
