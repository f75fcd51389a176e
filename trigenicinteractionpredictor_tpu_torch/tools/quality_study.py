"""EM-quality study on peaky ground truth: the quality knobs against plain
EM at comparable compute (counterpart of the reference's
``tools/quality_study.py``).

On a peaky synthetic config (generator Dirichlet alpha_theta = 0.05)
plain-EM chains converge far above the ground-truth likelihood, with a
held-out AUC well below the Bayes rate.  This study fits five arms on the
same 80/20 split -- plain, deterministic annealing, spectral init,
perturb-and-resweep refinement, and the three combined -- each at the same
total sweep budget, and prints one JSON line per arm (held-out AUC, best
train L, its gap to the generator's L, sweeps, wall seconds) and a summary
table, after a first line with the Bayes AUC ceiling and the
ground-truth train L.

With ``--seed-study N`` it runs the seed study instead: ``bench_quality``'s
loop at the two quality records of ``tests/perf_records.json`` (their own
args) for restart seeds 0 .. N-1, once from the reference's draw at the
seed (what ``bench_quality --seed s`` measures) and once from ``fit``'s
numpy draw at the seed (``models/mmsbm.py::init_state``), one JSON line
each with the AUC it settles at and the sweeps it takes to get there.

Usage:
    python -m trigenicinteractionpredictor_tpu_torch.tools.quality_study            # full scale, on the card
    python -m trigenicinteractionpredictor_tpu_torch.tools.quality_study --small --device cpu
    python -m trigenicinteractionpredictor_tpu_torch.tools.quality_study --seed-study 5

``--cpu`` is the reference's name for ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.config import Config, TrainConfig
from trigenicinteractionpredictor_tpu_torch.data.splits import train_test_split
from trigenicinteractionpredictor_tpu_torch.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu_torch.device import resolve_device
from trigenicinteractionpredictor_tpu_torch.eval import evaluate
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state, state_from_numpy
from trigenicinteractionpredictor_tpu_torch.ops.em import log_likelihood, make_batch
from trigenicinteractionpredictor_tpu_torch.ops.metrics import auc
from trigenicinteractionpredictor_tpu_torch.ops.scoring import predict_interaction
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit


def bayes_auc(theta, p, test_ds, interact_rating=1, device="cpu"):
    """AUC of the generating model's own scores -- the quality ceiling."""
    st = state_from_numpy(theta, p, device)
    trips = torch.as_tensor(np.asarray(test_ds.triplets), device=st.device)
    scores = predict_interaction(st, trips, interact_rating)
    labels = torch.as_tensor(np.asarray(test_ds.ratings) == interact_rating, device=st.device)
    return float(auc(scores, labels))


def ground_truth_ll(theta, p, ds, device="cpu"):
    """Train L of the generating model, over row chunks of 16,384."""
    st = state_from_numpy(theta, p, device)
    batch = make_batch(ds.triplets, ds.ratings, ds.weights, st.device)
    return float(log_likelihood(st, batch, row_chunk=16384))


def study_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--small", action="store_true", help="fast host-scale probe")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap


def study_device(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else args.device)


RECORDS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "perf_records.json")


def seed_study(seeds: int, device, records_path: str = RECORDS) -> list:
    """The quality records' runs at restart seeds 0 .. seeds-1, from both
    draws: one dict per (record, seed, draw), printed as a JSON line."""
    from trigenicinteractionpredictor_tpu_torch import bench_quality

    with open(records_path) as fh:
        records = json.load(fh)["quality"]
    lines = []
    for name in ("default", "recoverable"):
        for seed in range(seeds):
            args = bench_quality.parse_args(
                records[name]["args"] + ["--seed", str(seed), "--device", str(device)])
            ref = bench_quality.measure(args)
            case = bench_quality.quality_case(args)
            own = bench_quality.train_to_converged(
                case.step, init_state(args.genes, args.k, bench_quality.R,
                                      samples=args.samples, seed=seed, device=case.dev),
                case.check_auc, args.max_sweeps, args.freq, args.tol)
            for draw, auc_final, sweeps, per_sweep in (
                    ("reference", ref["auc_final"], ref["sweeps_to_converged"],
                     ref["seconds_per_sweep"]),
                    ("numpy", own.auc_final, own.sweeps_to_converged, own.seconds_per_sweep)):
                line = {"record": name, "seed": seed, "draw": draw, "auc_final": auc_final,
                        "sweeps_to_converged": sweeps, "seconds_per_sweep": per_sweep,
                        "device": str(case.dev)}
                print(json.dumps(line), flush=True)
                lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = study_parser(__doc__.splitlines()[0])
    ap.add_argument("-n", type=int, default=0, help="triplets (0 = scale default)")
    ap.add_argument("-g", "--genes", type=int, default=0)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("-s", "--samples", type=int, default=10)
    ap.add_argument("-i", "--sweeps", type=int, default=600)
    ap.add_argument("--alpha-theta", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--arms", default="plain,anneal,spectral,refine,combo")
    ap.add_argument("--seed-study", type=int, default=0, metavar="N",
                    help="run the quality records over restart seeds 0..N-1 from both "
                         "draws instead of the arms")
    args = ap.parse_args(argv)
    dev = study_device(args)
    if args.seed_study:
        seed_study(args.seed_study, dev)
        return 0

    if args.small:
        N = args.n or 20_000
        G = args.genes or 200
    else:
        N = args.n or 131_072
        G = args.genes or 1000
    K, S, sweeps = args.k, args.samples, args.sweeps

    ds, theta_star, p_star = sample_synthetic_dataset(
        N, G, K, alpha_theta=args.alpha_theta, alpha_p=0.3, seed=args.seed)
    train, test = train_test_split(ds, 0.2, 0)
    ceiling = bayes_auc(theta_star, p_star, test, device=dev)
    gt_ll = ground_truth_ll(theta_star, p_star, train, device=dev)
    print(json.dumps({
        "config": {"n": N, "g": G, "k": K, "s": S, "sweeps": sweeps,
                   "alpha_theta": args.alpha_theta, "seed": args.seed},
        "bayes_auc": round(ceiling, 4),
        "ground_truth_train_ll": round(gt_ll, 1),
    }), flush=True)

    base_train = TrainConfig(k=K, sweeps=sweeps, samples=S, likelihood_freq=50, seed=args.seed)
    # Comparable compute: every arm runs the same total sweep budget.  The
    # refine arms split it (main fit + rounds); anneal spends half of it on
    # the ramp.
    arms = {
        "plain": base_train,
        "anneal": dataclasses.replace(base_train, anneal_beta0=0.2, anneal_sweeps=sweeps // 2),
        "spectral": dataclasses.replace(base_train, init_method="spectral"),
        "refine": dataclasses.replace(base_train, sweeps=sweeps // 2, refine_rounds=2,
                                      refine_sweeps=sweeps // 4),
        "combo": dataclasses.replace(base_train, sweeps=sweeps // 2, anneal_beta0=0.2,
                                     anneal_sweeps=sweeps // 4, init_method="spectral",
                                     refine_rounds=2, refine_sweeps=sweeps // 4),
    }
    results = {}
    for name in args.arms.split(","):
        t0 = time.perf_counter()
        res = fit(Config(train=arms[name]), train, device=dev)
        wall = time.perf_counter() - t0
        rep = evaluate(res.states, test, res.final_loglik).to_dict()
        results[name] = {
            "auc": round(rep["auc"], 4),
            "train_ll_best": round(float(res.final_loglik.max()), 1),
            "gap_to_gt_ll": round(gt_ll - float(res.final_loglik.max()), 1),
            "sweeps": res.sweeps_run,
            "wall_s": round(wall, 1),
        }
        print(json.dumps({"arm": name, **results[name]}), flush=True)

    print("\n| arm | held-out AUC | train L best | L gap to truth | sweeps | wall s |")
    print("|---|---|---|---|---|---|")
    for name, r in results.items():
        print(f"| {name} | {r['auc']} | {r['train_ll_best']} | {r['gap_to_gt_ll']} | "
              f"{r['sweeps']} | {r['wall_s']} |")
    print(f"\nBayes AUC ceiling: {ceiling:.4f}; ground-truth train L {gt_ll:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
