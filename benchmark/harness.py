"""Runs one benchmark cell once and prints its result line.

Everything a cell is made of is found by name (``BENCHMARK.json`` names
each cell's configuration and traffic):

- ``benchmark/configs/<config>.json``: the configuration's sizes, from its
  ``file`` entry in ``BENCHMARK.json``;
- ``benchmark/traffic/<traffic>.json``: the traffic mix; its ``kind``
  names the general client ``benchmark/kinds/<kind>.py`` that runs it;
- ``benchmark/workloads/<cell>.json``: the route the cell measures (a run
  the program sends down another route is refused), the cell's comparison
  (the limit of each number compared, how many answers are compared) and
  the length of its traced window;
- ``benchmark/metrics/<metric>.py``: one reader per metric, ``read(run)``,
  returning the number or None when the run holds nothing to read.

A run: set-up (the client builds its inputs from the seed and warms up
every shape, so nothing compiles in the window), the measured window
(whole fits or calls until ``--seconds`` have passed; the one in flight
finishes and counts), the device's memory peak, the comparison of the
window's sampled answers with the plain reference
(``benchmark/reference.py``), the metrics, then the import guard, just
before the result is returned.  With ``--trace 1`` the
window runs under ``torch.profiler`` for the cell's ``trace_seconds`` and
the line carries the per-layer metrics, ``busy_s``, ``window_s`` and the
breakdown; with ``--trace 0`` it carries the end-to-end metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Optional

from benchmark import guard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "trigenicinteractionpredictor_tpu_torch"
OUT_DIR = ".bench_out"          # traces, under the checkout (listed in .gitignore)
CACHE_DIR = ".bench_cache"      # build and kernel caches, under the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    root: str
    spec: dict

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, "benchmark", *parts)


@dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    setup_s: float
    elapsed_s: float                 # the window, to the end of its last fit or call
    items: list                      # one record per fit or call of the window
    trace: Optional[object] = None   # trace.Trace of a traced run


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: str, name: str) -> Cell:
    spec = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(root, "benchmark", "traffic", w["traffic"] + ".json"))
    settings = _read_json(os.path.join(root, "benchmark", "workloads", name + ".json"))
    return Cell(name, int(w["chips"]), config, traffic, settings, root, spec)


def metrics_for(cell: Cell, section: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") this cell reports."""
    return [m for m in cell.spec[section]
            if "workloads" not in m or cell.name in m["workloads"]]


def query_card():
    """Start ``nvidia-smi`` reading the card's name and power limit; it runs
    while torch loads (:func:`card` waits for it)."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError as exc:
        return exc


def card(query) -> str:
    """What :func:`query_card` read, once the process has ended."""
    if isinstance(query, OSError):
        return f"nvidia-smi unavailable ({query})"
    try:
        out, _ = query.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        query.kill()
        query.communicate()
        return "nvidia-smi timed out"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: no output"


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
            t0: float, control: bool = False) -> dict:
    """Set up, measure, check and read one run of ``cell``; the result line."""
    import torch

    from benchmark import trace as tracing

    dev = torch.device(device)
    kind = load_module(cell.path("kinds", cell.traffic["kind"] + ".py"),
                       "bench_kind_" + cell.traffic["kind"])
    t_client = time.time()
    client = kind.Client(cell, seed, dev, control=control)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        if trace:
            tracing.warm_profiler()
    setup_s = time.time() - t0
    print(f"setup {setup_s:.3f} s: {t_client - t0:.3f} before the client, "
          f"{time.time() - t_client:.3f} in its inputs and warm-up", file=sys.stderr, flush=True)
    limit = min(seconds, cell.settings["trace_seconds"]) if trace else seconds
    trace_path = os.path.join(cell.root, OUT_DIR, cell.name + ".trace.json")
    items = []
    with (tracing.traced(trace_path) if trace else contextlib.nullcontext([])) as written:
        start = time.perf_counter()
        while True:
            items.append(client.item(len(items)))
            if time.perf_counter() - start >= limit:
                break
        elapsed = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = tracing.summarize(written[0]) if written else None
    if trace and dev.type == "cuda" and (summary is None or summary.busy_s <= 0):
        raise RuntimeError("the traced window holds no device time")
    routes = {}
    for it in items:
        routes[it["route"]] = routes.get(it["route"], 0) + 1
    host = sorted(it["host_s"] for it in items)
    print(f"routes of the window's {len(items)} calls: {routes}; host s a call: min "
          f"{host[0]:.6g}, median {host[len(host) // 2]:.6g}, max {host[-1]:.6g}",
          file=sys.stderr)
    client.close()
    t_check = time.perf_counter()
    checks = client.check()
    print(f"window {elapsed:.3f} s; comparison {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr, flush=True)
    run = Run(cell, setup_s, elapsed, items, summary)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(cell, section):
        value = load_module(cell.path("metrics", m["name"] + ".py"),
                            "bench_metric_" + m["name"].replace(".", "_")).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(_finite(v) and v <= lim for v, lim in checks.values())
    if dev.type == "cuda":
        device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                      "count": cell.chips, "memory_peak_bytes": int(peak)}
    else:
        device_rec = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": len(items), "failed": 0,
              "metrics": metrics, "device": device_rec}
    if summary is not None:
        device_rec.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    guard.check("after the window, the comparison and the metric readers")
    return result


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(result: dict) -> None:
    """The checks as the last lines of stderr, the result as stdout's last line."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    guard.check("at start")
    cell = load_cell(ROOT, args.workload)
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"the program {PROGRAM} is not in this checkout", file=sys.stderr)
        return 2
    query = query_card()
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    name = card(query)
    if found < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    print(f"card: {name}; cell {cell.name}, seed {args.seed}", file=sys.stderr, flush=True)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    emit(result)
    return 0


def configure_env(root: str) -> None:
    """Fixed cache directories inside the checkout, set before torch loads."""
    base = os.path.join(root, CACHE_DIR)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "cuda")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(base, "inductor")
