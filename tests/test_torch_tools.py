"""PyTorch port vs the JAX reference: the four measurement studies of
``trigenicinteractionpredictor_tpu_torch/tools/`` (counterparts of the
reference's ``tools/stepwise_host_cost.py``, ``quality_study.py``,
``split_merge_study.py`` and ``tensor_spectral_study.py``), on the CPU.

The studies' functions get the same seeded numpy inputs as the reference
tools' own (loaded by path from ``tools/``), within 1e-5: the scorers'
and the likelihood's float32 tolerance (tests/test_metrics.py).  Each
study runs as ``python -m`` in its small CPU mode and prints JSON lines
with the reference tool's keys (each key also read from the reference
tool's source).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from trigenicinteractionpredictor_tpu_torch.data import (
    sample_synthetic_dataset,
    train_test_split,
)
from trigenicinteractionpredictor_tpu_torch.tools import quality_study, tensor_spectral_study

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _peaky(n=3000, g=40, k=4, seed=11):
    ds, theta, p = sample_synthetic_dataset(n, g, k, alpha_theta=0.05, alpha_p=0.3, seed=seed)
    train, test = train_test_split(ds, 0.2, 0)
    return train, test, theta, p


@pytest.mark.parametrize("seed", [11, 12])
def test_bayes_auc_and_ground_truth_ll_match_reference(seed):
    ref = _reference_tool("quality_study")
    train, test, theta, p = _peaky(seed=seed)
    assert quality_study.bayes_auc(theta, p, test) == pytest.approx(
        ref.bayes_auc(theta, p, test), abs=1e-5)
    ll, ll_ref = quality_study.ground_truth_ll(theta, p, train), ref.ground_truth_ll(theta, p, train)
    assert ll == pytest.approx(ll_ref, rel=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_purity_and_unfold_labels_match_reference(seed):
    ref = _reference_tool("tensor_spectral_study")
    train, _, theta, _ = _peaky(n=2000, g=30, k=3)
    labels = tensor_spectral_study.unfold_labels(train, 30, 3, seed)
    np.testing.assert_array_equal(labels, ref.unfold_labels(train, 30, 3, seed))
    truth = np.argmax(theta, axis=1)
    rng = np.random.default_rng(seed)
    for lab in (labels, rng.integers(0, 3, size=30)):
        assert tensor_spectral_study.purity(lab, truth, 3) == pytest.approx(
            ref.purity(lab, truth, 3), abs=1e-5)


def _run(name, *args):
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", f"trigenicinteractionpredictor_tpu_torch.tools.{name}", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    source = open(os.path.join(REPO, "tools", f"{name}.py")).read()
    return lines, source


def _keys_from_reference(lines, source):
    for line in lines:
        for key in line:
            assert f'"{key}"' in source or f"{key}=" in source, key


TINY = ("-n", "3000", "-g", "40", "-k", "3")


def test_quality_study_small_cpu_mode_prints_the_reference_keys():
    lines, source = _run("quality_study", "--small", "--cpu", *TINY, "-s", "2", "-i", "8")
    assert set(lines[0]) == {"config", "bayes_auc", "ground_truth_train_ll"}
    arms = [ln for ln in lines[1:] if "arm" in ln]
    assert [a["arm"] for a in arms] == ["plain", "anneal", "spectral", "refine", "combo"]
    for a in arms:
        assert set(a) == {"arm", "auc", "train_ll_best", "gap_to_gt_ll", "sweeps", "wall_s"}
        assert 0.0 <= a["auc"] <= 1.0 and a["sweeps"] == 8
    _keys_from_reference(lines, source)


def test_split_merge_study_small_cpu_mode_prints_the_reference_keys():
    lines, source = _run("split_merge_study", "--small", "--device", "cpu", *TINY, "-s", "2",
                         "-i", "8", "--rounds", "2", "--cands", "3", "--resweep", "4")
    assert set(lines[1]) == {"arm", "train_ll_best", "auc"} and lines[1]["arm"] == "plain"
    rounds = [ln for ln in lines if "round" in ln]
    assert [r["round"] for r in rounds] == [0, 1]
    assert all(set(r) == {"round", "best_move", "cand_ll", "cur_ll", "accepted"} for r in rounds)
    last = lines[-1]
    assert last["arm"] == "split_merge" and last["extra_sweeps"] == 2 * 4 * 3
    assert last["rounds_accepted"] == sum(r["accepted"] for r in rounds)
    assert last["train_ll_best"] >= lines[1]["train_ll_best"]
    _keys_from_reference(lines, source)


def test_tensor_spectral_study_cpu_mode_prints_the_reference_keys():
    lines, source = _run("tensor_spectral_study", "--device", "cpu", *TINY, "--seeds", "1",
                         "--sweeps", "8", "--methods", "unfold")
    (rec,) = lines
    assert rec["method"] == "unfold" and rec["seeds"] == 1
    assert {"purity_mean", "purity_best"} <= set(rec)
    if rec["purity_best"] > 0.3:
        assert {"seeded_train_ll", "seeded_heldout_auc"} <= set(rec)
    _keys_from_reference(lines, source)


def test_stepwise_host_cost_splits_each_pipeline_within_its_total():
    """One line per pipeline (legacy, in-thread, a pool of 2), each stage's
    host seconds adding up to no more than the line's total; with no card
    and no rate given, the device keys are null."""
    lines, source = _run("stepwise_host_cost", "--n", "200000", "--mb", "16384",
                         "--workers", "2", "--device", "cpu")
    assert [ln["pipeline"] for ln in lines] == ["legacy", "r5-inthread", "pooled-2"]
    for ln in lines:
        stages = [v for key, v in ln.items() if key.startswith("t_") and key.endswith("_s")]
        assert len(stages) >= 2 and all(v >= 0 for v in stages)
        assert sum(stages) <= ln["host_total_s"] + 1e-3, ln
        assert ln["device_epoch_s_bdr_est"] is None and ln["host_over_device_bdr"] is None
        for key in ("pipeline", "host_total_s", "host_rows_per_s", "device_epoch_s_bdr_est",
                    "host_over_device_bdr", "host_over_device_onehot", "padded_mb_rows"):
            assert f'"{key}"' in source, key
    lines, _ = _run("stepwise_host_cost", "--n", "50000", "--mb", "16384", "--workers", "1",
                    "--device", "cpu", "--device-rows-per-s", "1e6", "--skip-legacy")
    (ln,) = lines
    assert ln["device_epoch_s_bdr_est"] == pytest.approx(50000 / 1e6, rel=1e-3)


def test_studies_import_no_jax():
    code = ("import sys\n"
            "import trigenicinteractionpredictor_tpu_torch.tools.stepwise_host_cost\n"
            "import trigenicinteractionpredictor_tpu_torch.tools.quality_study\n"
            "import trigenicinteractionpredictor_tpu_torch.tools.split_merge_study\n"
            "import trigenicinteractionpredictor_tpu_torch.tools.tensor_spectral_study\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m.startswith('trigenicinteractionpredictor_tpu.')\n"
            "       or m == 'trigenicinteractionpredictor_tpu']\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
