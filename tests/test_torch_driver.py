"""PyTorch port vs the JAX reference: the work-unit driver
(train/driver.py), the ``sweep``, ``cv`` and ``analyze`` commands and the
cross-restart analysis (analysis.py), on the CPU.

Reports compare exactly where both packages compute the same numbers from
the same files (merge_report, unit splits), and at the reference's own
scorer tolerance (rtol 1e-6, atol 1e-7; tests/test_metrics.py) where the
numbers come from scoring.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from trigenicinteractionpredictor_tpu.analysis import analyze_checkpoint as janalyze
from trigenicinteractionpredictor_tpu.config import Config, SplitConfig, TrainConfig
from trigenicinteractionpredictor_tpu.data.kuzmin import load_kuzmin_tsv
from trigenicinteractionpredictor_tpu.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu.train import driver as jdriver
from trigenicinteractionpredictor_tpu.utils.logging import JsonlLogger
from trigenicinteractionpredictor_tpu_torch import analysis
from trigenicinteractionpredictor_tpu_torch.train import driver
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TSV = os.path.join(REPO, "datasets", "example_trigenic.tsv")
SUMMARY_KEYS = {
    "mean_auc_selected", "mean_ap_selected", "mean_auc", "mean_ap",
    "best_k_per_fold", "best_auc_per_fold", "n_units",
}


def _cfg(tmp, folds=1, **train):
    base = dict(k=3, sweeps=6, samples=2, likelihood_freq=3)
    base.update(train)
    return Config(train=TrainConfig(**base), split=SplitConfig(n_folds=folds, seed=4),
                  out_dir=str(tmp))


def _ds():
    ds, _, _ = sample_synthetic_dataset(300, 20, 3, n_ratings=2, seed=8)
    return ds


@pytest.mark.parametrize("folds", [1, 3])
def test_work_units_match_jax(tmp_path, folds):
    cfg = _cfg(tmp_path, folds=folds)
    ds = _ds()
    got = driver.make_work_units(cfg, ds, [2, 5])
    want = jdriver.make_work_units(cfg, ds, [2, 5])
    assert [(u.fold, u.k, u.name) for u in got] == [(u.fold, u.k, u.name) for u in want]
    assert len(got) == 2 * folds
    for a, b in zip(got, want):
        for part in ("train_ds", "test_ds"):
            for field in ("triplets", "ratings", "weights"):
                np.testing.assert_array_equal(getattr(getattr(a, part), field),
                                              getattr(getattr(b, part), field))


def test_merge_report_matches_jax(tmp_path):
    """Both packages merge the same unit marker files into equal reports,
    selecting per fold on held-out L (and on training L where a marker
    lacks it)."""
    units = tmp_path / "units"
    units.mkdir()
    recs = [
        dict(unit="fold0_k5", fold=0, k=5, auc=0.61, average_precision=0.2,
             heldout_loglik=-90.0, ll_best=-300.0),
        dict(unit="fold0_k50", fold=0, k=50, auc=0.58, average_precision=0.3,
             heldout_loglik=-120.0, ll_best=-100.0),
        dict(unit="fold1_k5", fold=1, k=5, auc=0.55, average_precision=0.1,
             ll_best=-280.0),
        dict(unit="fold1_k10", fold=1, k=10, auc=0.57, average_precision=0.15,
             ll_best=-250.0),
    ]
    for r in recs:
        (units / f"{r['unit']}.json").write_text(json.dumps(r))
    got = driver.merge_report(str(tmp_path))
    want = jdriver.merge_report(str(tmp_path))
    assert got == want
    assert got["summary"]["best_k_per_fold"] == {"0": 5, "1": 10}
    assert json.load(open(tmp_path / "report.json")) == got
    assert driver.merge_report(str(tmp_path / "empty")) == {"units": [], "summary": {}}


def test_run_units_markers_skip_and_resume(tmp_path):
    """Units write DONE markers; a rerun skips them; a unit cut off after 3
    of its 6 sweeps (no marker, a 3-sweep checkpoint) resumes from its
    checkpoint and lands where the uninterrupted unit did."""
    cfg = _cfg(tmp_path)
    ds = _ds()
    first = driver.run_units(cfg, ds, k_grid=[2, 3], device="cpu")
    assert [r["unit"] for r in first] == ["fold0_k2", "fold0_k3"]
    for r in first:
        assert r["sweeps"] == 6 and r["dispatch"]["kernel"] == "torch"
        assert os.path.exists(tmp_path / "units" / f"{r['unit']}.json")
        assert os.path.exists(tmp_path / "units" / f"{r['unit']}.ckpt.npz")

    again = driver.run_units(cfg, ds, k_grid=[2, 3], device="cpu")
    assert again == first
    events = [json.loads(line)["event"] for line in open(tmp_path / "events_p0.jsonl")]
    assert events.count("unit_skipped_done") == 2

    os.remove(tmp_path / "units" / "fold0_k3.json")
    unit = driver.make_work_units(cfg, ds, [3])[0]
    fit(_cfg(tmp_path, sweeps=3), unit.train_ds, device="cpu",
        logger=JsonlLogger(None, echo=False),
        checkpoint_path=str(tmp_path / "units" / "fold0_k3.ckpt.npz"))
    resumed = driver.run_units(cfg, ds, k_grid=[2, 3], device="cpu")
    events = [json.loads(line) for line in open(tmp_path / "events_p0.jsonl")]
    starts = [e for e in events if e["event"] == "unit_start"]
    assert starts[-1]["unit"] == "fold0_k3" and starts[-1]["resume"] is True
    assert resumed[1]["sweeps"] == 6
    np.testing.assert_allclose(resumed[1]["ll_per_sample"], first[1]["ll_per_sample"],
                               rtol=1e-6)
    report = driver.merge_report(str(tmp_path))
    assert set(report["summary"]) == SUMMARY_KEYS and report["summary"]["n_units"] == 2


def test_run_units_is_one_process(tmp_path):
    """Each process runs its round-robin share of the units, in one process
    (the reference's ``i % process_count == process_index``): process 1 of
    2 runs the second unit only, logs to events_p1.jsonl and records its
    index."""
    recs = driver.run_units(_cfg(tmp_path), _ds(), k_grid=[2, 3], process_index=1,
                            process_count=2, device="cpu")
    assert [r["unit"] for r in recs] == ["fold0_k3"] and recs[0]["process"] == 1
    assert (tmp_path / "events_p1.jsonl").exists()
    assert sorted(os.listdir(tmp_path / "units")) == ["fold0_k3.ckpt.npz", "fold0_k3.json"]


@pytest.mark.parametrize(
    "argv,n_units",
    [
        (["sweep", "--k-grid", "2,3"], 2),
        (["cv", "-k", "2", "--folds", "3"], 3),
    ],
)
def test_cli_sweep_and_cv_write_report(tmp_path, capsys, argv, n_units):
    from trigenicinteractionpredictor_tpu_torch.cli import main

    out = str(tmp_path / "run")
    assert main([*argv, "-f", TSV, "-i", "6", "-s", "2", "-n", "3", "-o", out,
                 "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = json.load(open(os.path.join(out, "report.json")))
    assert report["summary"] == summary
    assert set(summary) == SUMMARY_KEYS and summary["n_units"] == n_units
    assert np.isfinite(summary["mean_auc_selected"])
    assert len(glob.glob(os.path.join(out, "units", "*.ckpt.npz"))) == n_units
    assert os.path.exists(os.path.join(out, "events_p0.jsonl"))
    assert os.path.exists(os.path.join(out, "config.json"))


def test_analyze_matches_jax(tmp_path, capsys):
    """The port's analysis of one checkpoint equals the reference's: group
    alignment, likelihood spread, score agreement and per-restart AUC."""
    from trigenicinteractionpredictor_tpu_torch.cli import main

    ds = load_kuzmin_tsv(TSV)
    ckpt = str(tmp_path / "m.npz")
    cfg = _cfg(tmp_path, k=3, sweeps=8, samples=3, likelihood_freq=4)
    fit(cfg, ds, device="cpu", logger=JsonlLogger(None, echo=False), checkpoint_path=ckpt)
    want = janalyze(ckpt, tuples=ds.triplets, labels=ds.ratings)
    got = analysis.analyze_checkpoint(ckpt, tuples=ds.triplets, labels=ds.ratings)
    assert got.keys() == want.keys()
    for key in ("checkpoint", "n_samples", "sweep", "best_sample"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["final_loglik_per_sample"],
                               want["final_loglik_per_sample"], rtol=1e-12)
    gs, ws = got["group_stability"], want["group_stability"]
    assert [a["permutation"] for a in gs["vs_restart0"]] == [
        a["permutation"] for a in ws["vs_restart0"]]
    np.testing.assert_allclose(gs["mean_alignment"], ws["mean_alignment"], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got["score_agreement"]["corr_matrix"]),
                               np.asarray(want["score_agreement"]["corr_matrix"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["per_sample_auc"], want["per_sample_auc"], atol=1e-6)

    out = str(tmp_path / "a.json")
    assert main(["analyze", "--checkpoint", ckpt, "-f", TSV, "-o", out,
                 "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["n_samples"] == 3 and printed["best_sample"] == want["best_sample"]
    assert json.load(open(out))["per_sample_auc"] == pytest.approx(got["per_sample_auc"])
