"""The port's spans (``utils/tracing.py``) on the CPU: where a fit and a
serve call put them in a ``torch.profiler`` trace, that nothing is
recorded with no profiler running, that the profiler leaves every result
bit-equal, and that the event log serialises nothing without a sink."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from trigenicinteractionpredictor_tpu_torch.config import Config, EngineConfig, TrainConfig
from trigenicinteractionpredictor_tpu_torch.data.splits import train_test_split
from trigenicinteractionpredictor_tpu_torch.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState, init_state
from trigenicinteractionpredictor_tpu_torch.ops import dispatch, em_bd, em_bdg, em_large_k, scoring
from trigenicinteractionpredictor_tpu_torch.train import trainer
from trigenicinteractionpredictor_tpu_torch.utils import logging as port_logging
from trigenicinteractionpredictor_tpu_torch.utils import tracing
from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger

torch.set_num_threads(2)

QUIET = JsonlLogger(None, echo=False)
SWEEPS, FREQ, S, K = 12, 4, 2, 3
# The fit's spans in the order they open; all nest under "fit".
FIT_ORDER = ["fit.prepare", "fit.make_batch", "fit.degrees", "fit.ll_fetch", "fit.finish"]
PREPARE_PARTS = ["fit.check_ids", "fit.route", "fit.init_states", "fit.make_batch",
                 "fit.degrees"]
# None: the plain sweep, no plan; the others build fit.plan inside fit.make_batch.
ROUTES = [None, em_bdg.KERNEL_NAME, em_large_k.KERNEL_NAME]


@pytest.fixture(scope="module")
def split():
    ds, _, _ = sample_synthetic_dataset(600, 30, K, n_ratings=2, seed=1)
    return train_test_split(ds, 0.2, seed=0)[0]


def _fit(train, route):
    cfg = Config(train=TrainConfig(k=K, sweeps=SWEEPS, samples=S, likelihood_freq=FREQ),
                 engine=EngineConfig(backend="jnp"))
    init = init_state(train.n_genes, K, train.n_ratings, samples=S, seed=3)
    fn = None if route is None else dispatch.stats_fn_for(route, K, train.n_ratings)
    return trainer.fit(cfg, train, device="cpu", logger=QUIET, stats_fn=fn,
                       init_states=ModelState(theta=init.theta.clone(), p=init.p.clone()))


def _serve_case(ensemble):
    states = init_state(40, K, 2, samples=S if ensemble else 1, seed=5)
    if not ensemble:
        states = ModelState(theta=states.theta[0], p=states.p[0])
    rows = np.random.default_rng(2).integers(0, 40, size=(2500, 3)).astype(np.int64)
    return states, rows


def _serve(case):
    states, rows = case
    return scoring.serve_predict_interaction(states, rows, 1, block_rows=1000)


def _spans(prof, tmp_path):
    """The program's spans of an exported trace: (name, start, end) by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("route", ROUTES)
def test_fit_spans_nest_under_fit_in_order(split, route, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _fit(split, route)
    spans = _spans(prof, tmp_path)
    roots = [s for s in spans if s[0] == "fit"]
    assert len(roots) == 1, spans
    assert all(_inside(s, roots[0]) for s in spans), spans
    first = {}
    for s in spans:
        first.setdefault(s[0], s)
    starts = [first[name][1] for name in FIT_ORDER]
    assert starts == sorted(starts), [(n, first[n]) for n in FIT_ORDER]
    for name in PREPARE_PARTS:
        assert _inside(first[name], first["fit.prepare"]), name
    assert first["fit.prepare"][2] <= first["fit.ll_fetch"][1] < first["fit.finish"][1]
    assert sum(s[0] == "fit.ll_fetch" for s in spans) == res.ll_trace.shape[0]
    plans = [s for s in spans if s[0] == "fit.plan"]
    assert len(plans) == (route is not None)
    assert all(_inside(s, first["fit.make_batch"]) for s in plans)
    assert not any(s[0] == "fit.checkpoint" for s in spans)


@pytest.mark.parametrize("route,parts", [
    (None, []),
    (em_bdg.KERNEL_NAME, ["fit.plan.g1", "fit.plan.scatter"]),
    (em_bd.KERNEL_NAME, ["fit.plan.scatter"]),
    (em_large_k.KERNEL_NAME, []),
])
def test_the_large_g_plans_are_split_inside_fit_plan(split, route, parts, tmp_path):
    """bdg's g1 plan and the scatter plans of the large-G routes record
    their own spans, one after the other inside ``fit.plan``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit(split, route)
    spans = _spans(prof, tmp_path)
    found = [s for s in spans if s[0].startswith("fit.plan.")]
    assert [s[0] for s in found] == parts
    plans = [s for s in spans if s[0] == "fit.plan"]
    assert all(_inside(s, plans[0]) for s in found)
    assert all(a[2] <= b[1] for a, b in zip(found, found[1:]))


@pytest.mark.parametrize("ensemble", [True, False])
def test_serve_spans_copy_in_and_score_each_block(ensemble, tmp_path):
    case = _serve_case(ensemble)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(case)
    spans = _spans(prof, tmp_path)
    assert spans[0][0] == "serve" and all(_inside(s, spans[0]) for s in spans)
    blocks = -(-case[1].shape[0] // 1000)
    want = ["serve.check_ids"] + ["serve.copy_in", "serve.score"] * blocks + ["serve.copy_out"]
    assert [s[0] for s in spans[1:]] == want
    ends = [s[2] for s in spans[1:]]
    assert all(a <= b[1] for a, b in zip(ends, spans[2:])), spans  # one after another


def test_span_without_profiler_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    off = tracing.span("fit")
    assert off is tracing.span("serve.copy_in") is tracing._OFF
    with off as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(tracing.span("fit"), torch.autograd.profiler.record_function)


@pytest.mark.parametrize("route", [None, em_bdg.KERNEL_NAME])
def test_fit_records_nothing_without_profiler(split, route, monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"span {name!r} recorded with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    res = _fit(split, route)
    assert res.sweeps_run == SWEEPS
    _serve(_serve_case(True))


@pytest.mark.parametrize("route", ROUTES)
def test_fit_bits_equal_with_and_without_profiler(split, route):
    plain = _fit(split, route)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _fit(split, route)
    assert torch.equal(plain.states.theta, traced.states.theta)
    assert torch.equal(plain.states.p, traced.states.p)
    np.testing.assert_array_equal(plain.ll_trace, traced.ll_trace)
    np.testing.assert_array_equal(plain.final_loglik, traced.final_loglik)


@pytest.mark.parametrize("ensemble", [True, False])
def test_serve_bits_equal_with_and_without_profiler(ensemble):
    case = _serve_case(ensemble)
    plain = _serve(case)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _serve(case)
    np.testing.assert_array_equal(plain, traced)


def test_logger_without_a_sink_serialises_nothing(monkeypatch, tmp_path):
    def refuse(*args, **kwargs):
        raise AssertionError("json.dumps called with no sink")

    monkeypatch.setattr(port_logging.json, "dumps", refuse)
    JsonlLogger(None, echo=False).log("sweep", sweep=1, ll_best=-1.5)
    monkeypatch.undo()
    path = tmp_path / "events.jsonl"
    with JsonlLogger(str(path), echo=False) as log:
        log.log("sweep", sweep=1)
    assert json.loads(path.read_text())["sweep"] == 1
