"""Shared set-up of the harness's tests: a throwaway checkout root holding
the benchmark's files plus tiny cells added as new files only (a tiny
configuration, a tiny screen mix, their per-cell files, which name the
CPU's route, and ``BENCHMARK.json`` entries), so the CPU runs through the
harness fast."""

import copy
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = {"n_triplets": 3000, "n_genes": 40, "k": 3}
CPU_ROUTE = "torch"  # the plain sweep and the plain scorer, the routes on the CPU
# tiny cell -> the real cell whose traffic and per-cell file it takes
TINY_CELLS = {
    "tiny.fit_s10": "kuzmin2018_k10.fit_s10",
    "tiny.fit_s1": "kuzmin2018_k10.fit_s10",
    "tiny.screen": "kuzmin2018_k10.screen_s10",
}


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


def build_tiny_root(tmp) -> str:
    root = str(tmp)
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "kuzmin2018_k10.json")) as fh:
        config = json.load(fh)
    _dump(os.path.join(bench, "configs", "tiny.json"), dict(config, name="tiny", **TINY))
    spec["configs"].append({"name": "tiny", "source": "https://doi.org/10.1126/science.aao1729",
                            "file": "benchmark/configs/tiny.json", "reduced": ["n_triplets", "n_genes", "k"],
                            "why": "a size the CPU tests hold"})
    with open(os.path.join(bench, "traffic", "screen_s10.json")) as fh:
        screen = json.load(fh)
    _dump(os.path.join(bench, "traffic", "screen_tiny.json"),
          dict(screen, rows_per_call=5000, block_rows=1024))
    with open(os.path.join(bench, "traffic", "fit_s10.json")) as fh:
        fit = json.load(fh)
    _dump(os.path.join(bench, "traffic", "fit_s1_tiny.json"), dict(fit, samples=1))
    cells = {w["name"]: w for w in spec["workloads"]}
    for name, real in TINY_CELLS.items():
        traffic = {"tiny.screen": "screen_tiny", "tiny.fit_s1": "fit_s1_tiny"}.get(
            name, cells[real]["traffic"])
        spec["workloads"].append(dict(cells[real], name=name, config="tiny", traffic=traffic))
        with open(os.path.join(bench, "workloads", real + ".json")) as fh:
            settings = json.load(fh)
        _dump(os.path.join(bench, "workloads", name + ".json"),
              dict(settings, route=CPU_ROUTE))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    _dump(os.path.join(root, "BENCHMARK.json"), spec)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return build_tiny_root(tmp_path_factory.mktemp("bench_root"))


@pytest.fixture
def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return copy.deepcopy(json.load(fh))
