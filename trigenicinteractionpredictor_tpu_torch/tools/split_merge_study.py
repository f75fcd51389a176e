"""Split-merge EM study on the peaky config (counterpart of the
reference's ``tools/split_merge_study.py``).

Split-merge EM (Ueda et al. 2000; the proposal move the trainer runs as
``TrainConfig.smem_rounds``, ``models/proposals.py``) makes structured
jumps between basins of different group topology, where annealing smooths
the landscape and restarts resample the same shallow basins.  This study
fits plain EM, then runs ``--rounds`` rounds: each draws ``--cands``
merge-split proposals from the best state, resweeps them all as one
restart-stacked fit (``fit(init_states=...)``) and keeps the best if it
beats the current L by more than 1e-6.  It prints the config line, the
plain arm, one line per round and the ``split_merge`` arm.

Usage:
    python -m trigenicinteractionpredictor_tpu_torch.tools.split_merge_study --small --device cpu
"""

from __future__ import annotations

import json
import time

import numpy as np

from trigenicinteractionpredictor_tpu_torch.config import Config, TrainConfig
from trigenicinteractionpredictor_tpu_torch.data.splits import train_test_split
from trigenicinteractionpredictor_tpu_torch.data.synthetic import sample_synthetic_dataset
from trigenicinteractionpredictor_tpu_torch.eval import evaluate
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState, state_from_numpy, to_numpy
from trigenicinteractionpredictor_tpu_torch.models.proposals import merge_split_candidate
from trigenicinteractionpredictor_tpu_torch.tools.quality_study import (
    bayes_auc,
    ground_truth_ll,
    study_device,
    study_parser,
)
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit


def main(argv=None) -> int:
    ap = study_parser(__doc__.splitlines()[0])
    ap.add_argument("-n", type=int, default=0)
    ap.add_argument("-g", "--genes", type=int, default=0)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("-s", "--samples", type=int, default=10)
    ap.add_argument("-i", "--sweeps", type=int, default=300, help="initial fit")
    ap.add_argument("--rounds", type=int, default=6, help="SMEM rounds")
    ap.add_argument("--cands", type=int, default=10, help="proposals per round")
    ap.add_argument("--resweep", type=int, default=100, help="sweeps per proposal")
    ap.add_argument("--alpha-theta", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)
    dev = study_device(args)

    N = args.n or (20_000 if args.small else 131_072)
    G = args.genes or (200 if args.small else 1000)
    K, S = args.k, args.samples

    ds, theta_star, p_star = sample_synthetic_dataset(
        N, G, K, alpha_theta=args.alpha_theta, alpha_p=0.3, seed=args.seed)
    train, test = train_test_split(ds, 0.2, 0)
    ceiling = bayes_auc(theta_star, p_star, test, device=dev)
    gt_ll = ground_truth_ll(theta_star, p_star, train, device=dev)
    print(json.dumps({
        "config": {"n": N, "g": G, "k": K, "s": S, "seed": args.seed},
        "bayes_auc": round(ceiling, 4),
        "ground_truth_train_ll": round(gt_ll, 1),
    }), flush=True)

    rng = np.random.default_rng(args.seed + 1)
    t0 = time.perf_counter()
    cfg0 = Config(train=TrainConfig(k=K, sweeps=args.sweeps, samples=S, likelihood_freq=50,
                                    seed=args.seed))
    res = fit(cfg0, train, device=dev)
    lane = int(np.argmax(res.final_loglik))
    best_ll = float(res.final_loglik[lane])
    theta = to_numpy(res.states.theta[lane]).astype(np.float64)
    p = to_numpy(res.states.p[lane]).astype(np.float64)
    rep = evaluate(res.states, test, res.final_loglik).to_dict()
    print(json.dumps({"arm": "plain", "train_ll_best": round(best_ll, 1),
                      "auc": round(rep["auc"], 4)}), flush=True)

    total_extra = 0
    cfg_re = Config(train=TrainConfig(k=K, sweeps=args.resweep, samples=args.cands,
                                      likelihood_freq=args.resweep, seed=args.seed))
    accepted = 0
    for rnd in range(args.rounds):
        thetas, ps, moves = [], [], []
        for _ in range(args.cands):
            th_c, p_c, mv = merge_split_candidate(theta, p, rng)
            thetas.append(th_c)
            ps.append(p_c)
            moves.append(mv)
        init = ModelState(theta=np.stack(thetas).astype(np.float32),
                          p=np.stack(ps).astype(np.float32))
        res_c = fit(cfg_re, train, device=dev, init_states=init)
        total_extra += args.resweep
        i = int(np.argmax(res_c.final_loglik))
        cand_ll = float(res_c.final_loglik[i])
        took = cand_ll > best_ll + 1e-6
        print(json.dumps({"round": rnd, "best_move": list(map(int, moves[i])),
                          "cand_ll": round(cand_ll, 1), "cur_ll": round(best_ll, 1),
                          "accepted": took}), flush=True)
        if took:
            accepted += 1
            best_ll = cand_ll
            theta = to_numpy(res_c.states.theta[i]).astype(np.float64)
            p = to_numpy(res_c.states.p[i]).astype(np.float64)

    final = state_from_numpy(theta[None], p[None], dev)
    rep_sm = evaluate(final, test, np.asarray([best_ll])).to_dict()
    print(json.dumps({
        "arm": "split_merge",
        "train_ll_best": round(best_ll, 1),
        "gap_to_gt_ll": round(gt_ll - best_ll, 1),
        "auc": round(rep_sm["auc"], 4),
        "rounds_accepted": accepted,
        "extra_sweeps": total_extra * args.cands,
        "wall_s": round(time.perf_counter() - t0, 1),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
