"""Time to converged held-out AUC (counterpart of the reference's root
``bench_quality.py``): the second half of the north-star metric.

    python -m trigenicinteractionpredictor_tpu_torch.bench_quality [--device cpu]

``bench.py`` measures raw sweep throughput; this measures how fast the
production step turns it into quality: the seconds of training, after the
kernels' build, until the ensemble's held-out AUC is within ``--tol`` of
its final value.  A kernel that got faster per sweep but broke the
restart axis or the normalize tail would pass the throughput bench and
fail this one.

Workload: the reference's synthetic ground truth (seed 0, Dirichlet
``--alpha`` for theta* and p*) with an 80/20 held-out split
(``data/splits.py``, seed 0); training runs the step ``fit`` runs
(``bench.make_engine_step``: the dispatched stats function, the fit's batch
and host plans, no row padding).  The restarts start from the reference's
own draw at ``--seed`` (``models/threefry.py``), not from the numpy draw
``fit`` starts from (``models/mmsbm.py::init_state``): the records of
``tests/perf_records.json`` were measured from the reference's draw, and
the sweeps the AUC takes to settle depend on the draw.  So
``sweeps_to_converged`` and ``seconds_to_converged_auc`` are those of the
reference's start, not of the start a user of ``fit`` gets.
Only the chained steps and the fetch of their last L row are timed; the AUC
check every ``--freq`` sweeps runs outside the timer, through the port's
serving scorer (``serve_predict_interaction``: K2 on the card).

Prints ONE JSON line with the reference's keys:
    {"metric": "seconds_to_converged_auc", "value": t, "unit": "s",
     "auc_final", "auc_bayes", "sweeps_to_converged", "seconds_per_sweep",
     "shape"}
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.bench import (
    check_launches,
    device_name,
    launch_counts,
    log,
    make_engine_step,
)
from trigenicinteractionpredictor_tpu_torch.data.splits import train_test_split
from trigenicinteractionpredictor_tpu_torch.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu_torch.device import resolve_device
from trigenicinteractionpredictor_tpu_torch.eval import evaluate
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState, state_from_numpy
from trigenicinteractionpredictor_tpu_torch.models.threefry import reference_init_states
from trigenicinteractionpredictor_tpu_torch.ops.dispatch import resolve_stats_fn
from trigenicinteractionpredictor_tpu_torch.ops.metrics import auc
from trigenicinteractionpredictor_tpu_torch.ops.scoring import (
    serve_predict_interaction,
    serve_route,
)

N = 131072
G = 1000
K = 10
R = 2
S = 10
FREQ = 10          # sweeps per check: the trainer's likelihood_freq default
MAX_SWEEPS = 300
TOL = 0.005


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", type=int, default=N)
    ap.add_argument("-g", "--genes", type=int, default=G)
    ap.add_argument("-k", type=int, default=K)
    ap.add_argument("-s", "--samples", type=int, default=S)
    ap.add_argument("--max-sweeps", type=int, default=MAX_SWEEPS)
    ap.add_argument("--freq", type=int, default=FREQ)
    ap.add_argument("--tol", type=float, default=TOL)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--seed", type=int, default=0,
                    help="restart-init seed, drawn as the reference draws it "
                         "(the data stay seed 0)")
    ap.add_argument("--alpha", type=float, default=0.2,
                    help="generator Dirichlet concentration of theta* and p*")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default; fails without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    if args.freq < 1 or args.max_sweeps < args.freq:
        ap.error("--max-sweeps must be at least --freq, and --freq at least 1")
    return args


@dataclass
class QualityRun:
    history: List[Tuple[float, int, float]]  # (train seconds so far, sweeps, ensemble AUC)
    auc_final: float
    seconds_to_converged: float
    sweeps_to_converged: int
    seconds_per_sweep: float
    final_ll: np.ndarray                     # L row of the last step (before its last sweep)
    states: ModelState


def auc_checker(test) -> Callable[[ModelState], float]:
    """``check_auc(states)``: the ensemble's held-out AUC on ``test``, scored
    by ``serve_predict_interaction`` on the states' device."""
    labels = torch.as_tensor((test.ratings == 1).astype(np.int32))
    weights = torch.as_tensor(test.weights)

    def check_auc(states: ModelState) -> float:
        return float(auc(torch.from_numpy(serve_predict_interaction(states, test.triplets)),
                         labels, weights))

    return check_auc


def train_to_converged(step: Callable, states0: ModelState, check_auc: Callable,
                       max_sweeps: int, freq: int, tol: float) -> QualityRun:
    """The timed loop: ``max_sweeps // freq`` steps of ``freq`` chained
    sweeps from ``states0``, each timed to the fetch of its last L row, then
    ``check_auc(states)`` outside the timer."""
    states, t_train, history, final_ll = states0, 0.0, [], None
    for chk in range(max_sweeps // freq):
        t0 = time.perf_counter()
        states, ll = step(states)
        final_ll = ll[-1].cpu().numpy()   # the fetch is the sync point
        t_train += time.perf_counter() - t0
        history.append((t_train, (chk + 1) * freq, check_auc(states)))
    auc_final = history[-1][2]
    t_conv, sweeps_conv = next((t, sw) for t, sw, a in history if a >= auc_final - tol)
    return QualityRun(history, auc_final, t_conv, sweeps_conv,
                      t_train / history[-1][1], final_ll.astype(np.float64), states)


@dataclass
class QualityCase:
    """A quality run's fixed parts: the split's step and AUC check."""

    dev: torch.device
    route: str
    step: Callable
    check_auc: Callable[[ModelState], float]
    train: object                            # the training TripletDataset
    test: object                             # the held-out TripletDataset
    truth: Tuple[np.ndarray, np.ndarray]     # the generating (theta*, p*)


def quality_case(args) -> QualityCase:
    """The data (seed 0), the 80/20 split, the dispatched step and the
    held-out AUC check at ``args``' shape."""
    dev = resolve_device(args.device)
    log(f"device: {device_name(dev)}")
    n, g, k, s = args.n, args.genes, args.k, args.samples
    ds, theta_star, p_star = sample_synthetic_dataset(
        n, g, k, n_ratings=R, alpha_theta=args.alpha, alpha_p=args.alpha, seed=0)
    train, test = train_test_split(ds, 0.2, seed=0)
    stats_fn = resolve_stats_fn(dev, 3, g, k, s, n_ratings=R, backend=args.backend,
                                n_rows=train.n_rows)
    log(f"route: {stats_fn.kernel_name}; scorer: {serve_route(dev.type, True, 3, k)}")
    return QualityCase(dev, stats_fn.kernel_name,
                       make_engine_step(train, stats_fn, dev, args.freq),
                       auc_checker(test), train, test, (theta_star, p_star))


def measure(args) -> dict:
    """Run the benchmark; return the JSON result."""
    case = quality_case(args)
    states0 = reference_init_states(args.seed, args.samples, args.genes, args.k, R,
                                    device=case.dev)
    # Untimed: one step (the kernels' build) and one AUC check.
    t0 = time.perf_counter()
    st, ll = case.step(states0)
    float(ll[-1, 0])
    case.check_auc(st)
    log(f"build + first step: {time.perf_counter() - t0:.3f}s")
    # Bayes ceiling: the generating (theta*, p*) scored as an ensemble of one.
    theta_star, p_star = case.truth
    bayes = case.check_auc(state_from_numpy(theta_star[None], p_star[None], case.dev))

    route = case.route
    before = launch_counts(route)
    run = train_to_converged(case.step, states0, case.check_auc, args.max_sweeps, args.freq,
                             args.tol)
    check_launches(route, {name: c - before[name] for name, c in launch_counts(route).items()},
                   run.history[-1][1])
    for t, sw, a in run.history:
        log(f"  t={t:9.6f}s sweeps={sw:4d} ensemble_auc={a:.6f}")
    log(f"route {route}: converged AUC {run.auc_final:.6f} (Bayes {bayes:.6f}); within "
        f"{args.tol} after {run.sweeps_to_converged} sweeps / "
        f"{run.seconds_to_converged:.6f}s of training")
    report = evaluate(run.states, case.test, run.final_ll)
    log(f"final evaluate(): {json.dumps(report.to_dict(), sort_keys=True)}")
    return {
        "metric": "seconds_to_converged_auc",
        "value": run.seconds_to_converged,
        "unit": "s",
        "auc_final": run.auc_final,
        "auc_bayes": bayes,
        "sweeps_to_converged": run.sweeps_to_converged,
        "seconds_per_sweep": run.seconds_per_sweep,
        "shape": {"n": args.n, "g": args.genes, "k": args.k, "s": args.samples,
                  "alpha": args.alpha, "seed": args.seed},
    }


def main(argv=None) -> int:
    print(json.dumps(measure(parse_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
