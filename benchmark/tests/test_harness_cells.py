"""Each traffic kind end to end on the CPU at a tiny size, through the
harness's own run (``harness.execute``, which skips only the look for a
CUDA device), against the plain reference: sound runs come out correct;
the control and each fault a cell can have come out not correct.

The faults are planted in the program underneath the timed path:

- a step that returns its state unchanged (fit) / an answer that returns
  the previous call's scores (screen);
- half of the batch left out, the mean taken over the rest: the sweep's
  statistics from the first half of the rows, doubled (fit) / the score
  averaged over the first half of the restarts (screen);
- an answer altered where it is produced: one theta entry of the
  returned fit, one score of the returned block.

The exchange between chips does not exist in these one-chip cells.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

from benchmark import harness

FIT_CELLS = ["tiny.fit_s10", "tiny.fit_s1"]
ALL_CELLS = FIT_CELLS + ["tiny.screen"]


def _run(root, cell, seed=2**33 + 5, seconds=0.3, trace=False, control=False):
    c = harness.load_cell(root, cell)
    return harness.execute(c, seed, seconds, trace, "cpu", time.time(), control=control)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    spec = harness.load_cell(tiny_root, cell)
    want = {m["name"] for m in harness.metrics_for(spec, "end_to_end")}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_control_precision_fails(tiny_root, cell):
    res = _run(tiny_root, cell, control=True)
    assert not res["correct"], res["checks"]


def _fit_fault(monkeypatch, fault):
    from trigenicinteractionpredictor_tpu_torch.ops.em import SweepStats, normalize_from_stats
    from trigenicinteractionpredictor_tpu_torch.train import trainer

    real_step, real_fit = trainer.sharded_step, trainer.fit
    if fault == "unchanged":
        def step(states, batch, degrees, mesh, stats_fn, beta=None, buffers=None):
            return states, real_step(states, batch, degrees, mesh, stats_fn, beta, buffers)[1]
        monkeypatch.setattr(trainer, "sharded_step", step)
    elif fault == "half_batch":
        def step(states, batch, degrees, mesh, stats_fn, beta=None, buffers=None):
            half = batch._replace(**{f: getattr(batch, f)[: batch.triplets.shape[0] // 2]
                                     for f in ("triplets", "ratings", "weights")})
            s = stats_fn(states.theta, states.p, half)
            s = SweepStats(2 * s.theta_hat, 2 * s.p_hat, 2 * s.loglik)
            return normalize_from_stats(states, s, degrees), s.loglik
        monkeypatch.setattr(trainer, "sharded_step", step)
    elif fault == "altered":
        def fit(*a, **kw):
            res = real_fit(*a, **kw)
            res.states.theta[0, 0, 0] += 1e-3
            return res
        monkeypatch.setattr(trainer, "fit", fit)


def _screen_fault(monkeypatch, fault):
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
    from trigenicinteractionpredictor_tpu_torch.ops import scoring

    real = scoring.serve_predict_interaction
    last = []

    def serve(states, triplets, *a, **kw):
        if fault == "half_batch":
            half = states.theta.shape[0] // 2
            states = ModelState(theta=states.theta[:half], p=states.p[:half])
        out = real(states, triplets, *a, **kw)
        if fault == "unchanged":
            last.append(out)
            return last[-2] if len(last) > 1 else np.zeros_like(out)
        if fault == "altered":
            out[len(out) // 2] += 1e-3
        return out

    monkeypatch.setattr(scoring, "serve_predict_interaction", serve)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    (_screen_fault if "screen" in cell else _fit_fault)(monkeypatch, fault)
    res = _run(tiny_root, cell, seconds=0.5)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_a_run_down_another_route_is_refused(tiny_root, tmp_path, cell):
    """A cell whose file names another route than the one the program
    takes (here a card's kernel route on the CPU) is not measured."""
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    path = os.path.join(root, "benchmark", "workloads", cell + ".json")
    with open(path) as fh:
        settings = json.load(fh)
    want = "cuda-score" if "screen" in cell else "cuda-em-sweep"
    with open(path, "w") as fh:
        json.dump(dict(settings, route=want), fh)
    with pytest.raises(RuntimeError, match=f"measures route {want}, but the program took "
                                           "route torch"):
        _run(root, cell)


def test_traced_run_on_the_cpu_reads_no_device_metric(tiny_root):
    res = _run(tiny_root, "tiny.fit_s1", trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"fit_outside_loop_ms"}
    assert res["device"]["busy_s"] == 0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_mix_and_metric_added_as_files_only(tiny_root, tmp_path):
    """A later change adds a cell, a traffic mix and a per-layer metric by
    adding files and BENCHMARK.json entries alone."""
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "traffic", "fit_s10.json")) as fh:
        mix = json.load(fh)
    with open(os.path.join(bench, "traffic", "fit_s3_short.json"), "w") as fh:
        json.dump(dict(mix, samples=3, sweeps=20), fh)
    shutil.copy(os.path.join(bench, "workloads", "tiny.fit_s10.json"),
                os.path.join(bench, "workloads", "tiny.fit_s3_short.json"))
    with open(os.path.join(bench, "metrics", "fit_sweeps_per_fit.py"), "w") as fh:
        fh.write("def read(run):\n"
                 "    return sum(it['sweeps'] for it in run.items) / len(run.items)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["workloads"].append({"name": "tiny.fit_s3_short", "config": "tiny",
                              "traffic": "fit_s3_short", "chips": 1, "why": "added by files"})
    for m in spec["end_to_end"]:
        if m["name"] == "fit_updates_per_s":
            m["workloads"].append("tiny.fit_s3_short")
    spec["per_layer"].append({"name": "fit_sweeps_per_fit", "unit": "sweeps", "better": "higher",
                              "source": "program_counter", "layer": "whole fit step",
                              "moves": "fit_updates_per_s", "workloads": ["tiny.fit_s3_short"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    res = _run(root, "tiny.fit_s3_short", trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["fit_sweeps_per_fit"] == {"value": 20.0, "unit": "sweeps"}
    res = _run(root, "tiny.fit_s3_short")
    assert set(res["metrics"]) == {"setup_s", "fit_updates_per_s"}
