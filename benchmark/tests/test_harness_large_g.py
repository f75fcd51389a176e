"""The large-G cell's shape through the harness on the CPU: a tiny copy of
``large_g100k.fit_s10`` with many genes against its rows (N = 3000, G =
6000: 1.2 training rows a gene, so about 30% of the genes are in no
training row and keep their rows), added to a throwaway root as new files only.  A sound run
is correct, the control is not, and the cell's new readers (the plan
span, K4's and K5b's roofline shares) read nothing on the CPU, where no
kernel runs."""

import json
import os
import shutil
import time

import numpy as np
import pytest

from benchmark import harness, synth

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REAL = "large_g100k.fit_s10"
CELL = "tiny_large_g.fit_s10"
TINY = {"name": "tiny_large_g", "n_triplets": 3000, "n_genes": 6000, "k": 3}
NEW_READERS = {"fit_plan_ms", "bdg_estep_roofline_pct", "plan_scatter_roofline_pct"}


def _dump(path, obj):
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("large_g_root"))
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "large_g100k.json")) as fh:
        config = json.load(fh)
    _dump(os.path.join(bench, "configs", "tiny_large_g.json"), dict(config, **TINY))
    spec["configs"].append({"name": "tiny_large_g", "source": "https://doi.org/10.1073/pnas.1606316113",
                            "file": "benchmark/configs/tiny_large_g.json",
                            "reduced": ["n_triplets", "n_genes", "k"],
                            "why": "a size the CPU tests hold"})
    real = {w["name"]: w for w in spec["workloads"]}[REAL]
    spec["workloads"].append(dict(real, name=CELL, config="tiny_large_g"))
    with open(os.path.join(bench, "workloads", REAL + ".json")) as fh:
        settings = json.load(fh)
    # The CPU runs the plain sweep whatever the shape.
    _dump(os.path.join(bench, "workloads", CELL + ".json"), dict(settings, route="torch"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    _dump(os.path.join(root, "BENCHMARK.json"), spec)
    return root


def _run(root, seed=2**33 + 17, trace=False, control=False):
    cell = harness.load_cell(root, CELL)
    return harness.execute(cell, seed, 0.3, trace, "cpu", time.time(), control=control)


def test_the_tiny_cell_leaves_genes_unseen(root):
    c = harness.load_cell(root, CELL).config
    rows = synth.train_rows(synth.planted_rows(c["n_triplets"], c["n_genes"], c["k"],
                                               c["n_ratings"], 0.5, 0.5, 2**33 + 17),
                            c["test_fraction"], 2**33 + 17)
    seen = np.unique(rows.triplets).size
    assert 0.1 * c["n_genes"] < c["n_genes"] - seen < 0.5 * c["n_genes"]


def test_sound_run_is_correct(root):
    res = _run(root)
    assert res["correct"], res["checks"]
    want = {m["name"] for m in harness.metrics_for(harness.load_cell(root, CELL), "end_to_end")}
    assert set(res["metrics"]) == want == {"setup_s", "fit_updates_per_s"}


def test_control_is_not_correct(root):
    res = _run(root, control=True)
    assert not res["correct"], res["checks"]


def test_new_readers_read_nothing_on_the_cpu(root):
    cell = harness.load_cell(root, CELL)
    assert NEW_READERS <= {m["name"] for m in harness.metrics_for(cell, "per_layer")}
    res = _run(root, trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] == 0
    assert not NEW_READERS & set(res["metrics"])
    assert set(res["metrics"]) == {"fit_outside_loop_ms"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_planted_fault_is_not_correct(root, monkeypatch, fault):
    """A step that returns its state unchanged, or whose statistics come
    from half the rows, doubled, is refused by the cell's limits.  (A
    change of 1e-3 to one theta entry is not: the float32 fit itself
    moves theta by up to 0.1 at this shape.)"""
    from trigenicinteractionpredictor_tpu_torch.ops.em import SweepStats, normalize_from_stats
    from trigenicinteractionpredictor_tpu_torch.train import trainer

    real = trainer.sharded_step

    def step(states, batch, degrees, mesh, stats_fn, beta=None, buffers=None):
        if fault == "unchanged":
            return states, real(states, batch, degrees, mesh, stats_fn, beta, buffers)[1]
        half = batch._replace(**{f: getattr(batch, f)[: batch.triplets.shape[0] // 2]
                                 for f in ("triplets", "ratings", "weights")})
        s = stats_fn(states.theta, states.p, half)
        s = SweepStats(2 * s.theta_hat, 2 * s.p_hat, 2 * s.loglik)
        return normalize_from_stats(states, s, degrees), s.loglik

    monkeypatch.setattr(trainer, "sharded_step", step)
    res = _run(root)
    assert not res["correct"], (fault, res["checks"])
