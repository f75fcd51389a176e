"""Traffic kind ``fit_tsv`` end to end on the CPU at a tiny size, through the
harness's own run: a Data S1 screen of 8 query pairs x 60 array genes
written from the seed, loaded through the program's Kuzmin loader and fit
on the plain route.  Sound runs come out correct and report the key
census; the control comes out not correct; a loader whose rows differ
from the plain reader's, and a program with no key census, are refused at
set-up."""

import json
import os
import shutil
import time

import numpy as np
import pytest

from benchmark import harness

REAL = "kuzmin2018_qxa_k10.fit_s10_tsv"
CELL = "tiny_qxa.fit_s10_tsv"
TINY_QXA = {"n_query_pairs": 8, "n_array_genes": 60, "n_triplets": 480, "n_genes": 76, "k": 3}
# The plain CPU sweep's float32 sums read L ~1e-5 (relative) at this size
# (9.5e-6, theta 1.1e-5, p 2.1e-5 at the first seed below), above the card
# cell's 4e-6 limit (its K1 reads 2.9e-7): the tiny cell takes the CPU fit
# tolerances of tests/test_torch_qxa_cell.py; the TF32 control reads L
# 8.9e-3, theta 2.2e-3, p 2.5e-3 here.
TINY_LIMITS = {"ll_gap": 1e-4, "theta_gap": 1e-4, "p_gap": 1e-4}


@pytest.fixture(scope="module")
def qxa_root(tiny_root, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("qxa_root"))
    shutil.rmtree(root)
    shutil.copytree(tiny_root, root)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "kuzmin2018_qxa_k10.json")) as fh:
        config = json.load(fh)
    with open(os.path.join(bench, "configs", "tiny_qxa.json"), "w") as fh:
        json.dump(dict(config, name="tiny_qxa", **TINY_QXA), fh)
    with open(os.path.join(bench, "workloads", REAL + ".json")) as fh:
        settings = json.load(fh)
    with open(os.path.join(bench, "workloads", CELL + ".json"), "w") as fh:
        json.dump(dict(settings, route="torch", limits=TINY_LIMITS), fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "tiny_qxa", "source": "https://doi.org/10.1126/science.aao1729",
                            "file": "benchmark/configs/tiny_qxa.json", "reduced": list(TINY_QXA),
                            "why": "a size the CPU tests hold"})
    real = {w["name"]: w for w in spec["workloads"]}[REAL]
    spec["workloads"].append(dict(real, name=CELL, config="tiny_qxa"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return root


def _run(root, seed=2**33 + 5, seconds=0.3, trace=False, control=False):
    c = harness.load_cell(root, CELL)
    return harness.execute(c, seed, seconds, trace, "cpu", time.time(), control=control)


def test_sound_run_is_correct_and_leaves_no_tsv(qxa_root):
    res = _run(qxa_root)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "fit_updates_per_s"}
    assert not [f for f in os.listdir(os.path.join(qxa_root, harness.CACHE_DIR))
                if f.endswith(".tsv")]


def test_traced_run_reports_the_key_chain(qxa_root):
    res = _run(qxa_root, trace=True)
    assert res["correct"], res["checks"]
    # 64-row tiles of one query pair hold each of its two genes 64 times
    # (the ragged tiles at a pair's end fewer): chains of ~50-70 marginals.
    assert 40 <= res["metrics"]["k1_key_chain"]["value"] <= 70
    assert res["metrics"]["k1_key_chain"]["unit"] == "marginals"


def test_control_precision_fails(qxa_root):
    res = _run(qxa_root, control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["label", "row", "gene"])
def test_a_loader_unlike_the_plain_reader_is_refused(qxa_root, monkeypatch, fault):
    from trigenicinteractionpredictor_tpu_torch.data import kuzmin

    real = kuzmin.load_kuzmin_tsv

    def load(path, cfg=None):
        ds = real(path, cfg)
        if fault == "label":
            ds.ratings[len(ds.ratings) // 2] ^= 1
        elif fault == "row":
            ds = ds.select(np.arange(1, ds.n_rows))
        else:
            ds.triplets[7, 2] = (ds.triplets[7, 2] + 1) % ds.n_genes
        return ds

    monkeypatch.setattr(kuzmin, "load_kuzmin_tsv", load)
    with pytest.raises(RuntimeError, match="differ from the plain reader's"):
        _run(qxa_root)


def test_a_program_without_the_key_census_fails_at_set_up(qxa_root, monkeypatch):
    from trigenicinteractionpredictor_tpu_torch.ops import em_bdr

    monkeypatch.delattr(em_bdr, "key_census")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="key_census"):
        _run(qxa_root)
    assert time.perf_counter() - t0 < 5.0
