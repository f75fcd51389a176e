"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import ast
import json
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion"
                   r"|experts_per_tok|^k$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _bench(*parts):
    return os.path.join(REPO, "benchmark", *parts)


def test_top_level_keys_and_size(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths(spec):
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(spec["command"]) <= 32 and all(_line(w) for w in spec["command"])
    script = spec["command"][1]
    assert any(script.startswith(p + "/") for p in spec["paths"])
    assert os.path.isfile(os.path.join(REPO, script))


def test_run_seconds_fits_a_full_check(spec):
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_uniqueness(spec):
    metrics = spec["end_to_end"] + spec["per_layer"]
    for group in (spec["configs"], spec["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if m["name"].endswith("_roofline") or "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs(spec):
    used = {w["config"] for w in spec["workloads"]}
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        with open(os.path.join(REPO, c["file"])) as fh:
            body = json.load(fh)
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        assert body["reduced"] == c["reduced"] and "assumed" in body


def test_cells_and_their_files(spec):
    configs = {c["name"] for c in spec["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert 1 <= len(pairs) <= 24 and len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(pairs) // 4)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        with open(_bench("traffic", w["traffic"] + ".json")) as fh:
            traffic = json.load(fh)
        assert os.path.isfile(_bench("kinds", traffic["kind"] + ".py"))
        with open(_bench("workloads", w["name"] + ".json")) as fh:
            settings = json.load(fh)
        assert NAME.match(settings["route"]), w["name"]
        assert settings["check_items"] >= 1 and settings["trace_seconds"] > 0
        assert settings["limits"] and all(v > 0 for v in settings["limits"].values())


def _reports(spec, section, cell):
    return [m["name"] for m in spec[section] if "workloads" not in m or cell in m["workloads"]]


def test_every_cell_reports_what_it_must(spec):
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in spec["workloads"]:
        got = _reports(spec, "end_to_end", w["name"])
        assert "setup_s" in got and len(got) >= 2, w["name"]
        assert _reports(spec, "per_layer", w["name"]), w["name"]
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in spec["workloads"]]):
            assert m["moves"] in _reports(spec, "end_to_end", cell), (m["name"], cell)


def test_every_metric_has_a_reader(spec):
    for m in spec["end_to_end"] + spec["per_layer"]:
        path = _bench("metrics", m["name"] + ".py")
        with open(path) as fh:
            tree = ast.parse(fh.read())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body), path


def test_file_names_under_paths(spec):
    for p in spec["paths"]:
        for dirpath, dirnames, filenames in os.walk(os.path.join(REPO, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in filenames:
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)
                assert PATH.match(rel), rel


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_per_layer_layers_and_cells_exist(spec, section):
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec[section]:
        assert set(m.get("workloads", [])) <= cells
