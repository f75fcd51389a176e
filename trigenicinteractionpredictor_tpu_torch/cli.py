"""Command-line entry points of the port (counterpart of the reference's
``cli.py``, for ``fit``, ``cv``, ``sweep``, ``predict``, ``analyze``,
``synth``, ``verify-parity`` and ``bench``):

    python -m trigenicinteractionpredictor_tpu_torch fit -f data.tsv -k 10 -i 400 -s 10 -o runs/fit
    python -m trigenicinteractionpredictor_tpu_torch fit -f store_dir -k 25 -s 2 -i 3 --minibatch 131072 --stream-groups 4
    python -m trigenicinteractionpredictor_tpu_torch sweep -f data.tsv --k-grid 5,10,25,50 -s 10 -o runs/sweep
    python -m trigenicinteractionpredictor_tpu_torch cv -f data.tsv -k 10 --folds 5 -o runs/cv
    python -m trigenicinteractionpredictor_tpu_torch predict -f data.tsv --checkpoint runs/fit/model.ckpt.npz
    python -m trigenicinteractionpredictor_tpu_torch analyze --checkpoint runs/fit/model.ckpt.npz -f data.tsv
    python -m trigenicinteractionpredictor_tpu_torch synth -o synth.npz -n 100000 -g 1000
    python -m trigenicinteractionpredictor_tpu_torch fit -f data.tsv --anneal-beta0 0.3 --smem-rounds 2 --refine-rounds 2 --init spectral
    python -m trigenicinteractionpredictor_tpu_torch verify-parity -f data.tsv -k 3 -o runs/parity [--no-fit] [--reference-mount DIR]
    python -m trigenicinteractionpredictor_tpu_torch bench -n 131072 -g 1000 -k 10 -s 10 --sweeps 120

Flags are the reference's, plus ``--device`` (default ``cuda``; a missing
GPU is an error that names ``--device cpu``).  ``--backend jnp`` runs the
plain PyTorch sweep on any device; ``auto`` and ``pallas`` (the default
``auto``) run the CUDA kernel that ``ops/dispatch.py::route`` picks for
the shape, including the large-G routes with their host plans.
``--precision`` is accepted and recorded: the sweep kernels are exact
float32 in both precision modes.  ``--minibatch`` runs stepwise EM
(``-i`` counts epochs), with ``--stream-groups``, ``--no-stream-prefetch``
and ``--stream-prep-workers`` as in the reference; ``-f`` may name a
``save_dir`` store, which is read memory-mapped.  ``fit`` prints the route
(and, stepwise, the minibatch layout) before its report.  The quality
knobs (``--anneal-beta0``, ``--refine-rounds``, ``--smem-rounds``,
``--init spectral``) reach every unit's ``fit`` in ``fit``, ``sweep`` and
``cv``.  What this engine does not run (annealing, refine or split-merge
with ``--minibatch``) is refused by the trainer, never ignored.  ``bench``
runs the port's ``bench.py`` in this process (the reference starts a
subprocess to keep its TPU claim out of the CLI; the port has no claim).

``fit``, ``cv`` and ``sweep`` run over several ranks, one process each,
started by torchrun (``parallel/distributed.py``)::

    python -m torch.distributed.run --nproc-per-node 2 -m trigenicinteractionpredictor_tpu_torch fit -f data.tsv --mesh-data 2 --device cpu
    python -m torch.distributed.run --nproc-per-node 2 -m trigenicinteractionpredictor_tpu_torch fit -f data.tsv --mesh-data 2 --device cuda:0 --dist-backend gloo
    python -m torch.distributed.run --nproc-per-node 8 -m trigenicinteractionpredictor_tpu_torch sweep -f data.tsv --k-grid 5,10,25,50

The first on the CPU, the second with two ranks sharing one card (gloo),
the third with one card a rank (nccl).  ``fit`` spreads one fit over the
mesh (``--mesh-data`` defaults to the ranks the other axes leave);
``cv`` and ``sweep`` give each rank its round-robin share of the units,
each fit on the rank's own card, then rank 0 merges the report after a
barrier.  Rank 0 alone writes ``config.json``, the checkpoint, the text
dump, ``report.json`` and ``events.jsonl``; rank r > 0 logs to
``events_p{r}.jsonl``.  ``predict`` and ``analyze`` run in one process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import List, Optional

import numpy as np


def _load_dataset(path: str, cfg):
    from trigenicinteractionpredictor_tpu_torch.data import (
        TripletDataset,
        load_kuzmin_tsv,
    )

    if os.path.isdir(path):
        return TripletDataset.load_dir(path, mmap=True)
    if path.endswith(".npz"):
        return TripletDataset.load_npz(path)
    return load_kuzmin_tsv(path, cfg.data)


def _base_parser(sub: argparse.ArgumentParser) -> None:
    sub.add_argument("-f", "--file", required=True, help="TSV or packed .npz dataset")
    sub.add_argument("-k", type=int, default=10, help="latent groups K")
    sub.add_argument("-i", "--iterations", type=int, default=400, help="EM sweeps")
    sub.add_argument("-s", "--samples", type=int, default=1, help="random restarts")
    sub.add_argument("-n", "--freq", type=int, default=10, help="likelihood check frequency")
    sub.add_argument("--tol", type=float, default=0.0, help="early-stop |dL| tolerance")
    sub.add_argument("--seed", type=int, default=0)
    sub.add_argument("-o", "--out", default=None, help="output directory")
    sub.add_argument(
        "--device", default="cuda",
        help="torch device: 'cuda' (default; fails without a GPU) or 'cpu'",
    )
    sub.add_argument("--mesh-data", type=int, default=None,
                     help="data-axis size (default: the ranks ensemble x model leave)")
    sub.add_argument("--mesh-ensemble", type=int, default=1,
                     help="ranks the restarts are split over")
    sub.add_argument("--mesh-model", type=int, default=1,
                     help="ranks p's l axis is split over (tensor parallelism, large K)")
    sub.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                     help="process-group backend under torchrun (default: nccl on CUDA, "
                          "gloo on the CPU; gloo lets ranks share one card)")
    sub.add_argument("--dist-timeout", type=float, default=1800.0,
                     help="seconds any collective may wait for the other ranks")
    sub.add_argument(
        "--backend", choices=["auto", "jnp", "pallas"], default="auto",
        help="'jnp': the plain PyTorch sweep on any device; 'auto'/'pallas': "
             "the CUDA kernel the shape routes to (recorded in the dispatch record)",
    )
    sub.add_argument(
        "--precision", choices=["fast", "strict"], default="fast",
        help="recorded; the port's sweep is exact float32 in both modes",
    )
    sub.add_argument("--bdr-group", type=int, default=0, help="recorded")
    sub.add_argument("--checkpoint-every", type=int, default=0)
    sub.add_argument("--test-fraction", type=float, default=0.2)
    sub.add_argument("--tau-mode", choices=["abs", "negative"], default="abs")
    sub.add_argument(
        "--mutant-type", choices=["trigenic", "digenic"], default="trigenic",
        help="TSV row filter: trigenic triplets or digenic pairs",
    )
    sub.add_argument("--p-cutoff", type=float, default=0.05)
    sub.add_argument("--tau-cutoff", type=float, default=0.08)
    sub.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler chrome trace of the fit to DIR",
    )
    sub.add_argument(
        "--debug-nans", action="store_true",
        help="raise on the first non-finite parameter (checked per chunk)",
    )
    sub.add_argument("--minibatch", type=int, default=0,
                     help="stepwise EM with minibatches of this many rows (0: classic EM)")
    sub.add_argument("--kappa", type=float, default=0.6)
    sub.add_argument("--stream-groups", type=int, default=0,
                     help="stepwise: minibatches per dispatch group (0: the whole epoch)")
    sub.add_argument("--no-stream-prefetch", action="store_true",
                     help="stepwise: no look-ahead group (one group on the device)")
    sub.add_argument("--stream-prep-workers", type=int, default=0,
                     help="stepwise: host prep processes (0: auto, 1: in-thread)")
    sub.add_argument("--anneal-beta0", type=float, default=1.0,
                     help="DAEM start inverse temperature (1.0: off; classic EM only)")
    sub.add_argument("--anneal-sweeps", type=int, default=0,
                     help="DAEM ramp length in sweeps (0: half the sweeps)")
    sub.add_argument("--refine-rounds", type=int, default=0,
                     help="perturb-and-resweep rounds after the fit (classic EM only)")
    sub.add_argument("--refine-sweeps", type=int, default=0,
                     help="sweeps per refine round (0: a quarter of the sweeps)")
    sub.add_argument("--refine-eps", type=float, default=0.25)
    sub.add_argument("--smem-rounds", type=int, default=0,
                     help="split-merge rounds after the fit, before refine (classic EM only)")
    sub.add_argument("--smem-sweeps", type=int, default=0,
                     help="sweeps per split-merge round (0: a quarter of the sweeps)")
    sub.add_argument(
        "--init", choices=["random", "spectral"], default="random",
        help="restart initialization ('spectral': from the data, G <= 23,170)",
    )


def _make_config(args, n_folds: int = 1):
    from trigenicinteractionpredictor_tpu_torch.config import (
        Config,
        DataConfig,
        EngineConfig,
        MeshConfig,
        SplitConfig,
        TrainConfig,
    )
    from trigenicinteractionpredictor_tpu_torch.parallel.distributed import topology

    ens, model = args.mesh_ensemble, args.mesh_model
    world = topology().process_count
    data = args.mesh_data if args.mesh_data is not None else max(world // (ens * model), 1)
    return Config(
        data=DataConfig(
            path=args.file,
            p_cutoff=args.p_cutoff,
            tau_cutoff=args.tau_cutoff,
            tau_mode=args.tau_mode,
            mutant_type=args.mutant_type,
        ),
        train=TrainConfig(
            k=args.k,
            sweeps=args.iterations,
            samples=args.samples,
            likelihood_freq=args.freq,
            tol=args.tol,
            seed=args.seed,
            checkpoint_every=args.checkpoint_every,
            debug_nans=args.debug_nans,
            minibatch=args.minibatch,
            stepwise_kappa=args.kappa,
            stream_groups=args.stream_groups,
            stream_prefetch=not args.no_stream_prefetch,
            stream_prep_workers=args.stream_prep_workers,
            anneal_beta0=args.anneal_beta0,
            anneal_sweeps=args.anneal_sweeps,
            refine_rounds=args.refine_rounds,
            refine_sweeps=args.refine_sweeps,
            refine_eps=args.refine_eps,
            smem_rounds=args.smem_rounds,
            smem_sweeps=args.smem_sweeps,
            init_method=args.init,
        ),
        split=SplitConfig(test_fraction=args.test_fraction, n_folds=n_folds, seed=args.seed),
        mesh=MeshConfig(data=data, ensemble=ens, model=model),
        engine=EngineConfig(
            backend=args.backend, precision=args.precision, bdr_group=args.bdr_group
        ),
        out_dir=args.out or "runs/run",
    )


def _start(args):
    """Join the ranks of a torchrun launch (a no-op in one process) and
    resolve this rank's device: ``(topology, device)``."""
    from datetime import timedelta

    from trigenicinteractionpredictor_tpu_torch.parallel.distributed import (
        maybe_initialize,
        rank_device,
    )

    topo = maybe_initialize(args.device, args.dist_backend,
                            timeout=timedelta(seconds=args.dist_timeout))
    return topo, rank_device(args.device)


def _rank_file(name: str, rank: int) -> str:
    """``name`` for rank 0, ``<stem>_p<rank><ext>`` for the others: no two
    ranks write one file."""
    stem, ext = os.path.splitext(name)
    return name if rank == 0 else f"{stem}_p{rank}{ext}"


def cmd_fit(args) -> int:
    from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger
    from trigenicinteractionpredictor_tpu_torch.data import train_test_split
    from trigenicinteractionpredictor_tpu_torch.eval import evaluate
    from trigenicinteractionpredictor_tpu_torch.train.checkpoint import write_text_dump
    from trigenicinteractionpredictor_tpu_torch.train.trainer import fit

    topo, dev = _start(args)
    rank = topo.process_index
    cfg = _make_config(args)
    os.makedirs(cfg.out_dir, exist_ok=True)
    if topo.is_coordinator:
        with open(os.path.join(cfg.out_dir, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
    ds = _load_dataset(args.file, cfg)
    train, test = train_test_split(ds, cfg.split.test_fraction, cfg.split.seed)
    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    events = os.path.join(cfg.out_dir, _rank_file("events.jsonl", rank))
    with JsonlLogger(events) as logger, prof:
        result = fit(
            cfg, train, device=dev, logger=logger,
            checkpoint_path=os.path.join(cfg.out_dir, "model.ckpt.npz"),
            resume=args.resume,
        )
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, _rank_file("trace.json", rank)))
    if not topo.is_coordinator:
        return 0  # every rank holds the gathered result; rank 0 reports it
    print(json.dumps({"route": result.dispatch.get("kernel"), "stepwise": result.layout}))
    report = evaluate(result.states, test, result.final_loglik)
    write_text_dump(
        os.path.join(cfg.out_dir, "params"), result.states, result.ll_trace,
        gene_names=ds.gene_names,
    )
    out = {
        **report.to_dict(),
        "ll_best": float(result.final_loglik.max()),
        "sweeps": result.sweeps_run,
        "triplets_per_sec": result.triplets_per_sec,
    }
    with open(os.path.join(cfg.out_dir, "report.json"), "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out))
    return 0


def _run_grid(args, k_grid: List[int], n_folds: int) -> int:
    from trigenicinteractionpredictor_tpu_torch.parallel.distributed import barrier
    from trigenicinteractionpredictor_tpu_torch.train.driver import merge_report, run_units

    topo, dev = _start(args)
    cfg = _make_config(args, n_folds=n_folds)
    os.makedirs(cfg.out_dir, exist_ok=True)
    if topo.is_coordinator:
        with open(os.path.join(cfg.out_dir, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
    ds = _load_dataset(args.file, cfg)
    run_units(cfg, ds, k_grid=k_grid, device=dev)
    # The merge reads every rank's DONE markers: wait for the slowest rank.
    barrier()
    if topo.is_coordinator:
        report = merge_report(cfg.out_dir)
        print(json.dumps(report["summary"]))
    return 0


def cmd_cv(args) -> int:
    return _run_grid(args, k_grid=[args.k], n_folds=args.folds)


def cmd_sweep(args) -> int:
    k_grid = [int(x) for x in args.k_grid.split(",")]
    return _run_grid(args, k_grid=k_grid, n_folds=args.folds)


def cmd_predict(args) -> int:
    from trigenicinteractionpredictor_tpu_torch.device import resolve_device
    from trigenicinteractionpredictor_tpu_torch.ops.scoring import (
        serve_predict_interaction,
        serve_route,
    )
    from trigenicinteractionpredictor_tpu_torch.train.checkpoint import load_checkpoint

    dev = resolve_device(args.device)
    cfg = _make_config(args)
    ds = _load_dataset(args.file, cfg)
    states = load_checkpoint(args.checkpoint, dev)["states"]
    if dev.type == "cuda":
        from trigenicinteractionpredictor_tpu_torch.ops import _build

        _build.library()  # set-up, kept out of the timed scoring
    t0 = time.perf_counter()
    scores = serve_predict_interaction(states, ds.triplets)  # numpy: synced
    score_wall = time.perf_counter() - t0
    out = args.out or "predictions.tsv"
    names = ds.gene_names or [str(i) for i in range(ds.n_genes)]
    cols = ["gene_a", "gene_b", "gene_c"][: ds.arity]
    gene_cols = np.asarray(names, dtype=object)[ds.triplets]
    with open(out, "w") as fh:
        fh.write("\t".join(cols) + "\tp_interaction\n")
        fh.write(
            "\n".join(
                "\t".join(row) + f"\t{s:.6f}" for row, s in zip(gene_cols, scores)
            )
        )
        fh.write("\n")
    print(json.dumps({
        "n": len(scores),
        "out": out,
        "rows_per_sec": round(len(scores) / max(score_wall, 1e-9), 1),
        "device": str(dev),
        "kernel": serve_route(dev.type, states.theta.dim() == 3, ds.arity, states.k),
    }))
    return 0


def cmd_analyze(args) -> int:
    from trigenicinteractionpredictor_tpu_torch.config import DataConfig
    from trigenicinteractionpredictor_tpu_torch.analysis import (
        analyze_checkpoint,
        write_analysis,
    )
    from trigenicinteractionpredictor_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    tuples = labels = None
    if args.file:
        class _DataOnly:
            data = DataConfig(
                path=args.file, p_cutoff=args.p_cutoff, tau_cutoff=args.tau_cutoff,
                tau_mode=args.tau_mode, mutant_type=args.mutant_type,
            )

        ds = _load_dataset(args.file, _DataOnly)
        tuples, labels = ds.triplets, ds.ratings
    report = analyze_checkpoint(args.checkpoint, tuples=tuples, labels=labels, device=dev)
    write_analysis(report, args.out or "analysis.json")
    print(json.dumps({
        k: report[k]
        for k in ("n_samples", "best_sample", "loglik_spread", "group_stability")
        if k in report
    }))
    return 0


def cmd_synth(args) -> int:
    from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset

    ds, theta, p = sample_synthetic_dataset(
        args.n, args.genes, args.k, n_ratings=args.ratings, seed=args.seed,
        arity=args.arity,
    )
    written = ds.save_npz(args.out)
    if args.ground_truth:
        np.savez(args.ground_truth, theta=theta, p=p)
    print(json.dumps({"out": written, "n": ds.n_rows, "genes": ds.n_genes, "k": args.k}))
    return 0


def cmd_verify_parity(args) -> int:
    from trigenicinteractionpredictor_tpu_torch.device import resolve_device
    from trigenicinteractionpredictor_tpu_torch.parity import run_verify_parity

    dev = resolve_device(args.device)
    cfg = _make_config(args)
    report = run_verify_parity(args.file, cfg, cfg.out_dir, do_fit=not args.no_fit,
                               device=dev, reference_mount=args.reference_mount)
    summary = {
        "reference_files": report["reference_mount"]["n_files"],
        "out": os.path.join(cfg.out_dir, "verify_parity.json"),
        **{k: v["rows"] for k, v in report["loader_fingerprint"]["modes"].items()},
    }
    if "artifact" in report:
        summary["heldout_auc"] = report["artifact"]["converged"]["auc"]
        summary["train_ll_best"] = report["artifact"]["converged"]["train_loglik_best"]
    print(json.dumps(summary))
    return 0


def cmd_bench(args) -> int:
    from trigenicinteractionpredictor_tpu_torch import bench

    return bench.run(args)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="trigenicinteractionpredictor_tpu_torch",
        description="PyTorch/CUDA MMSBM engine for trigenic interaction prediction",
    )
    subs = parser.add_subparsers(dest="cmd", required=True)

    p_fit = subs.add_parser("fit", help="train on one 80/20 split and evaluate")
    _base_parser(p_fit)
    p_fit.add_argument("--resume", default=None, help="checkpoint to resume from")
    p_fit.set_defaults(fn=cmd_fit)

    p_cv = subs.add_parser("cv", help="k-fold cross-validation at fixed K")
    _base_parser(p_cv)
    p_cv.add_argument("--folds", type=int, default=5)
    p_cv.set_defaults(fn=cmd_cv)

    p_sw = subs.add_parser("sweep", help="K-grid sweep with best-L selection")
    _base_parser(p_sw)
    p_sw.add_argument("--k-grid", default="5,10,25,50")
    p_sw.add_argument("--folds", type=int, default=1)
    p_sw.set_defaults(fn=cmd_sweep)

    p_pr = subs.add_parser("predict", help="score triplets from a checkpoint")
    _base_parser(p_pr)
    p_pr.add_argument("--checkpoint", required=True)
    p_pr.set_defaults(fn=cmd_predict)

    p_an = subs.add_parser(
        "analyze", help="cross-restart agreement/stability report from a checkpoint"
    )
    p_an.add_argument("--checkpoint", required=True)
    p_an.add_argument(
        "-f", "--file", default=None,
        help="optional probe dataset (TSV or .npz) for score agreement + AUC",
    )
    p_an.add_argument("-o", "--out", default=None, help="output JSON path")
    p_an.add_argument("--tau-mode", choices=["abs", "negative"], default="abs")
    p_an.add_argument("--p-cutoff", type=float, default=0.05)
    p_an.add_argument("--tau-cutoff", type=float, default=0.08)
    p_an.add_argument(
        "--mutant-type", choices=["trigenic", "digenic"], default="trigenic"
    )
    p_an.add_argument(
        "--device", default="cuda",
        help="torch device: 'cuda' (default; fails without a GPU) or 'cpu'",
    )
    p_an.set_defaults(fn=cmd_analyze)

    p_sy = subs.add_parser("synth", help="generate a synthetic packed dataset")
    p_sy.add_argument("-o", "--out", required=True)
    p_sy.add_argument("-n", type=int, default=100_000)
    p_sy.add_argument("-g", "--genes", type=int, default=1000)
    p_sy.add_argument("-k", type=int, default=10)
    p_sy.add_argument("--ratings", type=int, default=2)
    p_sy.add_argument("--arity", type=int, choices=[2, 3], default=3,
                      help="genes per observation: 3 (trigenic) or 2 (digenic)")
    p_sy.add_argument("--seed", type=int, default=0)
    p_sy.add_argument("--ground-truth", default=None, help=".npz for (theta*, p*)")
    p_sy.set_defaults(fn=cmd_synth)

    p_vp = subs.add_parser(
        "verify-parity",
        help="parity-readiness gate: reference-mount status, loader fingerprint, "
             "and a reference-comparable converged artifact (docs/PARITY.md)",
    )
    _base_parser(p_vp)
    p_vp.add_argument("--no-fit", action="store_true",
                      help="fingerprint only; skip the training/artifact stage")
    p_vp.add_argument("--reference-mount", default=None, metavar="DIR",
                      help="directory that should hold the upstream reference tree")
    p_vp.set_defaults(fn=cmd_verify_parity)

    from trigenicinteractionpredictor_tpu_torch import bench

    p_be = subs.add_parser("bench", parents=[bench.arg_parser(add_help=False)],
                           help="run the repo benchmark (bench.py)")
    p_be.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    from trigenicinteractionpredictor_tpu_torch.parallel.distributed import shutdown

    try:
        return args.fn(args)
    finally:
        shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
