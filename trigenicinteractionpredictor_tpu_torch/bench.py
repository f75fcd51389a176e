"""Headline benchmark of the port: EM restart-triplet updates/s on one card
(counterpart of the reference's root ``bench.py``).

    python -m trigenicinteractionpredictor_tpu_torch.bench [--serve] [--device cpu]
    python -m trigenicinteractionpredictor_tpu_torch bench -n 131072 -g 1000 -k 10 -s 10

Prints ONE JSON line on stdout, the reference's:
    {"metric": "em_restart_triplet_updates_per_sec_per_chip", "value": N,
     "unit": "triplets/s", "vs_baseline": N}
with ``shape`` added when the shape is not the headline one.

- Workload: the reference's default job shape (N = 131,072 synthetic
  triplets, G = 1000, K = 10, R = 2, S = 10 restarts) resident on the card;
  each step is ``likelihood_freq`` = 10 chained whole-ensemble EM sweeps
  (stats + normalize + likelihood), the step ``fit`` runs: the dispatched
  sweep route (``ops/dispatch.py::resolve_stats_fn`` with this shard's
  rows), the fit's batch with the route's plan (``Sweep.batch``) and
  ``parallel/sharded_em.py::sharded_multi_step`` on the one-rank mesh.
- Unit: one (triplet, restart) EM update, the unit of the pure-Python
  stand-in (``baselines/python_reference.py``, loaded by path so both
  engines divide by the same code); ``vs_baseline`` is the ratio.
- Timing: the first step is untimed (it builds the kernels); then the best
  of 3 runs of ``--sweeps // 10`` chained steps, each ended by fetching the
  last L row (a sync).  The S = 1 datapoint goes to stderr first.
- Launch check: on the card, every kernel the route names must have
  launched once a sweep that ran, else the bench raises (a silent fall
  through to the plain sweep is a different measurement).

``--serve`` times device-resident ensemble scoring instead (K2 on the card,
``ops/score.py::ensemble_score`` called directly) and prints the
reference's ``ensemble_serving_rows_per_sec_per_chip`` line.  Everything
else goes to stderr.  ``--device`` defaults to ``cuda`` and fails without
a GPU; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List

import torch

from trigenicinteractionpredictor_tpu_torch.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu_torch.device import resolve_device
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState, init_state
from trigenicinteractionpredictor_tpu_torch.ops import score
from trigenicinteractionpredictor_tpu_torch.ops.dispatch import resolve_stats_fn, route_kernels
from trigenicinteractionpredictor_tpu_torch.ops.scoring import (
    ensemble_predict_interaction,
    serve_route,
)
from trigenicinteractionpredictor_tpu_torch.parallel.mesh import single_device_mesh
from trigenicinteractionpredictor_tpu_torch.parallel.sharded_em import sharded_multi_step

N = 131072
G = 1000
K = 10
R = 2
S = 10       # restarts: the reference CLI's default ``-s 10``
SWEEPS = 120
CHUNK = 10   # sweeps a step: the trainer's likelihood_freq default
REPS = 3
SERVE_CALLS = 20
PLAIN_SCORER = "torch"  # ops/scoring.py::serve_route's plain scorer
BASELINE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "baselines", "python_reference.py")


def arg_parser(add_help: bool = True) -> argparse.ArgumentParser:
    """The reference's flags and defaults, plus ``--device`` (the CLI's
    ``bench`` takes this parser as its parent)."""
    ap = argparse.ArgumentParser(description=__doc__, add_help=add_help,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", type=int, default=N, help="triplets")
    ap.add_argument("-g", "--genes", type=int, default=G)
    ap.add_argument("-k", type=int, default=K)
    ap.add_argument("-s", "--samples", type=int, default=S)
    ap.add_argument("--sweeps", type=int, default=SWEEPS)
    ap.add_argument("--backend", default="auto", choices=["auto", "jnp", "pallas"])
    ap.add_argument("--warm-only", action="store_true",
                    help="build the kernels, run one step of each S and exit untimed")
    ap.add_argument("--serve", action="store_true",
                    help="measure device-resident ensemble scoring rows/s instead "
                         "(K2 on the card); prints its own JSON metric line")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default; fails without a GPU) or 'cpu'")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return arg_parser().parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def route_counters(route: str) -> Dict[str, Callable]:
    """The wrappers of the kernels ``route`` launches once a call, by kernel
    name: a sweep route's from ``ops/dispatch.py::route_kernels`` (which
    raises on a route it does not know), K2's for the serving scorer, none
    for the plain sweep or scorer."""
    if route == score.KERNEL_NAME:
        fns = (score.ensemble_score,)
    elif route == PLAIN_SCORER:
        fns = ()
    else:
        fns = route_kernels(route)
    return {fn.kernel_name: fn for fn in fns}


def launch_counts(route: str) -> Dict[str, int]:
    return {name: fn.launches for name, fn in route_counters(route).items()}


def check_launches(route: str, grew: Dict[str, int], calls: int) -> None:
    """Raise unless every kernel ``route`` names launched ``calls`` times."""
    for name in route_counters(route):
        if grew.get(name, 0) != calls:
            raise RuntimeError(
                f"route {route}: kernel {name} launched {grew.get(name, 0)} times for "
                f"{calls} calls; the bench measured something other than its route"
            )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def make_engine_step(ds, stats_fn, dev, n_inner: int = CHUNK) -> Callable:
    """The chained step ``fit`` runs with the route ``stats_fn``, on ``ds``'s
    rows: ``step(states) -> (states, ll_hist [n_inner, S])``, row i the L
    before sweep i."""
    batch = stats_fn.batch(ds, dev)[0]
    degrees = torch.as_tensor(ds.degrees(), device=dev)
    mesh = single_device_mesh()

    def step(states: ModelState):
        return sharded_multi_step(states, batch, degrees, mesh, n_inner, stats_fn)

    return step


@dataclass
class EngineRun:
    """One ensemble width's measurement."""

    samples: int
    route: str
    seconds: float               # best timed run (0 with --warm-only)
    sweeps: int                  # sweeps of one timed run
    updates_per_sec: float       # restart-triplet updates/s (0 with --warm-only)
    ll_best: float
    launches: Dict[str, int]     # kernel name -> launches of the first step and the reps


def engine_run(args, ds, dev, n_samples: int, reps: int = REPS) -> EngineRun:
    """Time ``reps`` runs of ``args.sweeps // 10`` chained steps at
    ``n_samples`` restarts; check the route's launches."""
    stats_fn = resolve_stats_fn(dev, 3, args.genes, args.k, n_samples, n_ratings=R,
                                backend=args.backend, n_rows=ds.n_rows)
    route = stats_fn.kernel_name
    before = launch_counts(route)
    step = make_engine_step(ds, stats_fn, dev)
    states0 = init_state(args.genes, args.k, R, samples=n_samples, seed=0, device=dev)
    t0 = time.perf_counter()
    states, ll_hist = step(states0)
    float(ll_hist[-1, 0])
    first = time.perf_counter() - t0
    log(f"S={n_samples} route {route}: first step (build + run) {first:.3f}s")
    n_chunks = args.sweeps // CHUNK
    calls, best_dt, ll_best = CHUNK, 0.0, float(ll_hist[-1].max())
    if not args.warm_only:
        best_dt = float("inf")
        for _ in range(reps):
            states = states0
            t0 = time.perf_counter()
            for _ in range(n_chunks):
                states, ll_hist = step(states)
            ll_best = float(ll_hist[-1].max())  # the fetch is the sync point
            best_dt = min(best_dt, time.perf_counter() - t0)
        calls += reps * n_chunks * CHUNK
    grew = {name: n - before[name] for name, n in launch_counts(route).items()}
    check_launches(route, grew, calls)
    sweeps = n_chunks * CHUNK
    tps = sweeps * ds.n_rows * n_samples / best_dt if best_dt else 0.0
    if not args.warm_only:
        log(f"S={n_samples} route {route}: {sweeps} sweeps x {ds.n_rows} triplets x "
            f"{n_samples} restarts in {best_dt:.6f}s (best of {reps}) -> {tps:.6e} "
            f"restart-triplet updates/s/chip (best L={ll_best:.6g}); launches {grew}")
    return EngineRun(n_samples, route, best_dt, sweeps, tps, ll_best, grew)


def measure_engine(args) -> List[EngineRun]:
    """The S = 1 datapoint, then the headline at ``args.samples``."""
    dev = resolve_device(args.device)
    log(f"device: {device_name(dev)}")
    ds, _, _ = sample_synthetic_dataset(args.n, args.genes, args.k, n_ratings=R, seed=0)
    return [engine_run(args, ds, dev, n) for n in (1, args.samples)]


def measure_baseline(args) -> float:
    """Best of 3 runs of the reference-shaped pure-Python EM, triplets/s
    (one CPU core); an understated baseline would overstate vs_baseline."""
    if not os.path.isfile(BASELINE):
        raise FileNotFoundError(
            f"the pure-Python baseline {BASELINE} is missing; vs_baseline needs it")
    spec = importlib.util.spec_from_file_location("python_reference", BASELINE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tps = max(
        mod.measure_triplets_per_sec(n_triplets=200, n_genes=args.genes, k=args.k,
                                     n_ratings=R, min_seconds=1.5)
        for _ in range(3)
    )
    log(f"pure-Python reference-shaped EM: {tps:,.0f} triplets/s (1 CPU core, best of 3)")
    return tps


@dataclass
class ServingRun:
    route: str
    ms: float                    # best mean ms a call (0 with --warm-only)
    rows_per_sec: float
    launches: Dict[str, int]
    scores: torch.Tensor         # the timed scorer's output [N]
    states: ModelState
    triplets: torch.Tensor


def measure_serving(args) -> ServingRun:
    """Device-resident ensemble scoring rows/s: states and rows put on the
    device once, the scorer of ``serve_route`` called directly, best of
    3 x 20 calls with a sync before each clock read."""
    dev = resolve_device(args.device)
    log(f"device: {device_name(dev)}")
    n, g, k, s = args.n, args.genes, args.k, args.samples
    ds, _, _ = sample_synthetic_dataset(n, g, k, n_ratings=R, seed=0)
    states = init_state(g, k, R, samples=s, seed=0, device=dev)
    trips = torch.as_tensor(ds.triplets, dtype=torch.int32, device=dev).contiguous()
    route = serve_route(dev.type, True, 3, k)
    if route == score.KERNEL_NAME:
        def fn():
            return score.ensemble_score(states.theta, states.p, trips, 1)
    else:
        def fn():
            return ensemble_predict_interaction(states, trips, 1)
    log(f"serving scorer: {route}")
    before = launch_counts(route)
    out = fn()
    _sync(dev)
    calls, best = 1, 0.0
    if not args.warm_only:
        best = float("inf")
        for _ in range(REPS):
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(SERVE_CALLS):
                out = fn()
            _sync(dev)
            best = min(best, (time.perf_counter() - t0) / SERVE_CALLS)
        calls += REPS * SERVE_CALLS
    grew = {name: c - before[name] for name, c in launch_counts(route).items()}
    check_launches(route, grew, calls)
    rows = n / best if best else 0.0
    if not args.warm_only:
        log(f"serving: {n} rows x {s} restarts in {best * 1e3:.4f} ms -> {rows:.6e} "
            f"rows/s/chip (device-resident; {route}); launches {grew}")
    return ServingRun(route, best * 1e3, rows, grew, out, states, trips)


def run(args: argparse.Namespace) -> int:
    """The bench on parsed flags (``main``'s and the CLI's ``bench``)."""
    if not args.serve and args.sweeps < CHUNK:
        raise SystemExit(f"--sweeps must be at least {CHUNK} (one chained step)")
    if args.serve:
        run = measure_serving(args)
        if args.warm_only:
            print(json.dumps({"metric": "warm_only", "value": 1, "unit": "cache"}))
            return 0
        print(json.dumps({
            "metric": "ensemble_serving_rows_per_sec_per_chip",
            "value": round(run.rows_per_sec, 1),
            "unit": "rows/s",
            "vs_baseline": 0.0,
            "shape": {"n": args.n, "g": args.genes, "k": args.k, "s": args.samples},
        }))
        return 0
    engine_tps = measure_engine(args)[-1].updates_per_sec
    if args.warm_only:
        print(json.dumps({"metric": "warm_only", "value": 1, "unit": "cache"}))
        return 0
    baseline_tps = measure_baseline(args)
    result = {
        "metric": "em_restart_triplet_updates_per_sec_per_chip",
        "value": round(engine_tps, 1),
        "unit": "triplets/s",
        "vs_baseline": round(engine_tps / baseline_tps, 1),
    }
    if (args.n, args.genes, args.k, args.samples) != (N, G, K, S):
        result["shape"] = {"n": args.n, "g": args.genes, "k": args.k, "s": args.samples}
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
