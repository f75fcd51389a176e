#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device   -- needs CUDA; prints the card's name and power limit;
2. build    -- compiles the port's CUDA kernels from csrc/ with nvcc;
2b. the integrity sentinel -- ``check_em_integrity`` with its verdict cache
               in a temp file: every probe's kernel, shape, error over its
               scale and ms; a second call hits the in-process cache and a
               third (in-process cache cleared) the disk cache, both with
               no launch; a K1 output scaled by 0.9 fails its probe, and the
               check raises ``ComputeIntegrityError`` on it.  Later fits
               find the verdict cached, so the probes' launches count in no
               later phase;
3. K1       -- the EM sweep kernel against its plain PyTorch version at the
               headline shape (N = 131,072 rows, G = 1000, K = 10, R = 2,
               S = 10), with both times from CUDA events;
4. K3       -- the large-K EM sweep kernel against its plain version at the
               headline N, G, R, S for K = 25, 50, 64 and 72, with both times,
               and at K = 50 and 72 its two passes' device times apart
               (``torch.profiler``); then at K8's shape (K = 64, G = 4000);
5. K2       -- the scoring kernel against its plain version at the headline
               shape, at K = 50, and at G = 100,000 with 16,384 rows;
6. the fit path -- ``fit`` (S = 10, K = 10, 50 sweeps, likelihood every
               10, checkpoints in a temp dir), ``evaluate`` on the 20% split
               and ``serve_predict_interaction`` on all rows, with the
               kernels' launch counts set to 0 just before that run and read
               just after; then a small fit through the kernel against the
               same fit through the plain sweep;
7. the K-sweep job -- ``sweep --k-grid 5,10,25,50`` through the CLI on
               ``synth`` data at the headline shape (S = 10, 20 sweeps per
               unit, likelihood every 10), then all rows served from the
               K = 50 unit's checkpoint, with the counts set to 0 just
               before and read just after;
8. the large-G fit -- each large-G kernel against its plain version and
               float64, with its time, the plain time and K1's time at the
               same shape: K4 (em_bdg) + K5b (plan_scatter) at N = 131,072,
               G = 100,000, K = 10, R = 2, S = 10; K5a (em_streams) + K5b at
               G = 500,000, S = 10; K6 (em_streams + plan_scatter, S = 1) at
               G = 100,000; K4 + K5b at G = 10,000, S = 50.  Then ``synth
               -g 100000`` -> ``fit -s 10 -i 30`` -> ``predict`` through the
               CLI (route cuda-em-bdg), a 30-sweep ``fit`` on the bd-plan
               route (G = 500,000, S = 10) and on the large-G route
               (G = 100,000, S = 1), each with the counts set to 0 just
               before and read just after; then a small fit (G = 6000)
               through each of the three routes against the plain fit;
9. stepwise EM -- K7 (em_hybrid) against its plain version and float64,
               with K3's time at the same shape, at K = 25, G = 6000, S = 2;
               K = 50, G = 4000, S = 1; K = 64, G = 2000, S = 1 (131,072
               rows, a stepwise minibatch).  Then ``synth -n 1048576 -g 6000
               -k 25`` -> ``fit --minibatch 131072 --stream-groups 4 -k 25
               -s 2 -i 3`` -> ``predict`` through the CLI (route
               cuda-em-hybrid); the streaming job: a 10^7-row ``save_dir``
               store (G = 1000, K = 10, S = 10) fit memory-mapped through
               ``train.trainer.fit`` with minibatch 131,072, 8 stream groups
               and 2 epochs on K1, with an epoch's host prep, host-to-device
               copy, K1 and device time measured apart; each with the counts
               set to 0 just before and read just after; then a small
               stepwise fit through K1, K3 and K7 against the plain route's
               stepwise fit;
10. the rating-sorted fit -- K9 (em_rsorted) against its plain version and
               float64 at the headline shape with plan tiles of 512 rows, and
               at K9's top K (28), with K1's time (K3's at K = 28) on the same
               rows unsorted; a 50-sweep classic ``fit`` through
               ``em_rsorted.stats_fn()`` from phase 6's seed and split (final
               L within FIT_RTOL of phase 6's K1 fit); a stepwise fit through
               K9 at N = 1,048,576, G = 1000, K = 10, S = 10 (minibatch
               131,072, 4 stream groups, 2 epochs: 16 launches) against the
               same fit on K1; each fit with the counts set to 0 just before
               and read just after;
11. the quality knobs -- K1 (K = 10) and K3 (K = 50) on (theta^0.3,
               p^0.3) at the headline shape against their plain versions and
               float64; then through the CLI on phase 6's rows and split, each
               with the counts set to 0 just before and read just after: an
               annealed ``fit`` (beta0 0.3, a 20-sweep ramp, 50 sweeps; no L
               drop from the check at the ramp's end + 2 freq), a
               ``--init spectral`` fit (the host init's seconds apart), and
               ``fit -i 40`` with 2 split-merge and 2 refine rounds of 10
               sweeps (80 sweeps, the best final L not below the main fit's);
               a small fit with all four knobs through K1 against the plain
               fit (final L and every accepted move); ``verify-parity`` on
               ``datasets/example_trigenic.tsv`` (the native tokenizer ran,
               the fingerprint's counts equal the Python parser's, K1 and K2
               launched), and the native and Python parse times of a
               200,000-row file (host CPU);
12. the multi-rank engine -- worlds started by torchrun (``python -m
               torch.distributed.run``), every rank on the one card
               (``cuda:0``), each rank's kernel launches set to 0 just before
               its fit and read just after, and the per-sweep all_reduce at
               the fit's shape timed by CUDA events: 12a phase 6's fit as a
               world of one under NCCL (final L and L trace equal to phase
               6's fit); 12b
               two gloo ranks, ``data 2``, and 12c four, ``data 2 x
               ensemble 2`` (K1 on each rank's rows and restarts; the same
               stop sweep and L within 1e-5 of phase 6's fit); 12d two ranks,
               ``model 2``, K = 50, S = 2, 10 sweeps, against the one-process
               K3 fit (L rtol 1e-5, theta and p atol 2e-5); 12e ``sweep
               --k-grid 5,10`` on two ranks through the CLI (one unit a rank;
               records within 1e-5 of the one-process job); 12f phase 9b's
               stepwise fit over ``data 2`` (K7; final L within 1e-4 of the
               one-process fit).  The ranks share one card, so these runs
               check the code across ranks, not scaling over GPUs;
13. the bench entry point (``bench.py``, ``bench_quality.py``), each run
               with the counts set to 0 just before and read just after:
               13a ``bench`` through the CLI at the headline shape, in
               process (the reference's metric line, ``vs_baseline >= 100``
               against ``baselines/python_reference.py``, route
               cuda-em-sweep at S = 1 and 10, K1 launched 2 x (10 + 3 x 120)
               times and nothing else, the S = 1 datapoint and sweeps/s beside
               phase 6's fit); 13b ``bench --serve`` (K2 launched 1 + 3 x 20
               times, the timed output within SCORE_ATOL of the plain
               scorer); 13c ``bench.measure_engine`` at the args of the
               throughput records of ``tests/perf_records.json``
               (large_k50_s10, large_g100k_s10, wide_s50_k10,
               bd_plan_wide_s50_g10k): the route at each S and every kernel
               it names launched once a sweep; 13d ``bench_quality`` at both
               quality records, held to their AUC band, sweeps slack and
               chance floor (seconds are the card's own, held to nothing),
               then the same loop from ``fit``'s own numpy draw (seed 0),
               held to the AUC band and chance floor.  After each run of
               13a and 13c, at each S, and for 13d's first step: one chained
               step from the run's initial states through the routed and the
               plain sweep, each on its own fit batch of the same rows,
               theta and p within STATS_REL_TOL, every L within LOGLIK_RTOL.
14. the same bits from run to run -- each sweep route at the shapes of
               phases 3-10 (SAME_BITS_ROUTES: K1 at G = 1000 and in its
               streams form at G = 100,000, K3 at K = 50 and 72, K7, K4 + K5b,
               K5a + K5b at G = 500,000, K6, K9 and the plain sweep on CUDA)
               run twice on the route's fit batch: theta_hat, p_hat and loglik
               equal (``torch.equal``), and each kernel the route names
               launched twice; phase 6's fit run again: the same final states,
               L trace and final L; phase 11e's four-knob fit run twice on
               the kernel route: the same final L lane for lane, the same
               rounds (from, to, accepted move) and the same final states;
15. the studies -- ``tools/stepwise_host_cost``, ``quality_study``,
               ``split_merge_study`` and ``tensor_spectral_study`` at a small
               size on the card, in process, each printing its JSON lines;
               then the block sum (``csrc/block_sum.cu``) timed at K1's
               partials of the headline shape, against its plain version and
               one ``torch.sum``, and run twice for the same bits.

The line before the last holds the kernels' record as JSON (``launches``
sums the counted paths that run the kernel; ``bound_ms`` is the larger of
the bytes the call must move over 3.35 TB/s and its float32 operations
over 67 TFLOP/s, from this run's shapes; ``library_ms`` is one PyTorch
call computing the same function, or null); the last line is ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HEADLINE = dict(n=131_072, genes=1000, k=10, ratings=2, samples=10)
LARGE_G_SWEEPS = 30   # the CLI large-G job
ROUTE_SWEEPS = 30     # the bd-plan and large-G fits
K3_GRID = (25, 50, 64, 72)
K3_TOP_SWEEPS = 10    # the K = 72 fit through the CLI
SWEEP_GRID = "5,10,25,50"
SWEEP_SWEEPS = 20
# Tolerances of kernel vs plain version.  Both run in float32 and sum in
# other orders (each in an order fixed by its inputs and plan); each
# p_hat cell sums over all N rows, so the expected relative error of either
# is ~sqrt(N) * 2^-24 ~ 2e-5 at N = 131,072.  Stated as: the max abs error
# of theta_hat and p_hat over the largest |plain| entry; the relative error
# of each restart's loglik; the max abs error of a served probability.
# Both float32 results are also compared with a float64 run of the plain
# version, and those errors are printed.
STATS_REL_TOL = 1e-4
LOGLIK_RTOL = 1e-5
SCORE_ATOL = 1e-5
FIT_RTOL = 1e-4       # final L of a small fit, kernel vs plain sweep
LL_DROP_RTOL = 1e-5   # largest allowed relative drop along the L trace
# The card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W):
# float32 outside the tensor cores and device-memory bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
K7_SHAPES = ((25, 6000, 2), (50, 4000, 1), (64, 2000, 1))  # (K, G, S)
STEPWISE_N, STEPWISE_MB = 1_048_576, 131_072
STREAM_N, STREAM_GROUPS, STREAM_EPOCHS = 10_000_000, 8, 2
RSORT_TILE = 512      # plan tile of the rating-sorted path (its default)
ANNEAL_BETA = 0.3     # the DAEM start of phase 11
K8_SHAPE = (64, 4000)  # (K, G) where the reference runs its bdrg kernel (K8)
BLOCK_SUM = "cuda-block-sum"  # ops/block_sum.py's kernel name


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(flops: float, nbytes: float):
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops, t_mem = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def _sweep_flops(rows: int, k: int, s: int) -> float:
    """One sweep's float32 operations: per real row and restart, T = th3 p
    and A3 = (th1 th2) p (K^3 multiply-adds each, the row's rating only),
    the cross-stats (K^3), A1, A2, W (K^2 each) and D."""
    return 2.0 * rows * s * (3 * k**3 + 3 * k**2 + k)


def _sweep_bytes(b: int, g: int, k: int, r: int, s: int, theta_in=None, extra=0) -> float:
    """A sweep's bytes, each input read once and each output written once:
    theta (or ``theta_in`` bytes of pre-gathered rows), p, 20 bytes a row
    (3 ids, rating, weight), theta_hat, p_hat, loglik, and ``extra``."""
    theta, p = 4.0 * s * g * k, 4.0 * s * k**3 * r
    return (theta if theta_in is None else theta_in) + p + 20.0 * b + theta + p + 4 * s + extra


def _check_stats(tag: str, out, ref, f64) -> float:
    """Assert a sweep kernel's stats against its plain version; print both
    float32 results' errors against a float64 run; return the max abs err."""
    import torch

    worst = 0.0
    for name in ("theta_hat", "p_hat"):
        a, b, c = getattr(out, name), getattr(ref, name), getattr(f64, name)
        err = float((a - b).abs().max())
        rel = err / float(b.abs().max())
        top = float(c.abs().max())
        print(f"[{tag}] {name}: kernel vs plain max abs err {err:.3e}, / max|plain| "
              f"{rel:.3e} (tol {STATS_REL_TOL:g}); vs float64 / max: kernel "
              f"{float((a - c).abs().max()) / top:.3e}, plain "
              f"{float((b - c).abs().max()) / top:.3e}")
        assert torch.isfinite(a).all() and rel <= STATS_REL_TOL, (tag, name)
        worst = max(worst, err)
    ll_rel = float(((out.loglik - ref.loglik).abs() / ref.loglik.abs()).max())
    ll64 = float(((out.loglik - f64.loglik).abs() / f64.loglik.abs()).max())
    print(f"[{tag}] loglik: max rel err {ll_rel:.3e} (tol {LOGLIK_RTOL:g}); "
          f"vs float64 {ll64:.3e}")
    assert ll_rel <= LOGLIK_RTOL, tag
    return worst


def _max_drop(trace) -> float:
    """Largest relative decrease between consecutive L checks (any restart)."""
    import numpy as np

    if len(trace) < 2:
        return 0.0
    return float(np.max((trace[:-1] - trace[1:]) / np.abs(trace[:-1])))


def _by_restarts(fn, thetas, ps, batch, group: int = 10):
    """``fn``'s SweepStats over restart groups, concatenated: the stats are
    per restart, and groups bound the plain version's memory at S = 50."""
    import torch

    parts = [fn(thetas[i:i + group], ps[i:i + group], batch)
             for i in range(0, thetas.shape[0], group)]
    return type(parts[0])(*(torch.cat(x) for x in zip(*parts)))


def _max_err(pairs) -> float:
    return max(float((a - b).abs().max()) for a, b in pairs)


def large_g_phase(card: str, dev, cli_main) -> list:
    """Phase 8 (see the module docstring); returns the new kernels'
    records for the ``kernels`` line."""
    import numpy as np
    import torch

    from trigenicinteractionpredictor_tpu_torch import Config
    from trigenicinteractionpredictor_tpu_torch.data import (
        sample_synthetic_dataset,
        train_test_split,
    )
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu_torch.ops import (
        dispatch,
        em_bd,
        em_bdg,
        em_bdr,
        em_large_g,
        score,
    )
    from trigenicinteractionpredictor_tpu_torch.ops.em import make_batch
    from trigenicinteractionpredictor_tpu_torch.train.checkpoint import load_checkpoint
    from trigenicinteractionpredictor_tpu_torch.train.trainer import JsonlLogger, fit

    N, K, R = HEADLINE["n"], HEADLINE["k"], HEADLINE["ratings"]
    wb1 = em_bdg.bdg_plan(K, R)[1]
    rec = {}

    # 8a. each kernel against its plain version and float64, with K1's time
    for tag, g, S, kind in (("K4+K5b", 100_000, 10, "bdg"), ("K5a+K5b", 500_000, 10, "bd"),
                            ("K6", 100_000, 1, "large"), ("K4+K5b", 10_000, 50, "bdg")):
        shape = f"N={N}, G={g}, K={K}, R={R}, S={S}"
        ds, _, _ = sample_synthetic_dataset(N, g, K, n_ratings=R, seed=5)
        st = init_state(g, K, R, samples=S, seed=6, device=dev)
        th, p = st.theta, st.p
        plain_batch = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
        positions = (1, 2) if kind == "bdg" else (0, 1, 2)
        trip = ds.triplets
        if kind == "bdg":
            g1 = em_bdg.make_g1_plan(ds.triplets, g, wb1=wb1)
            trip, rat, w = em_bdg.apply_g1_order(g1, ds.triplets, ds.ratings, ds.weights)
            plan = em_large_g.make_scatter_plan(trip, g, positions=(1, 2))
            batch = make_batch(trip, rat, w, dev, scatter=plan, g1=g1)
            whole = lambda: em_bdg.bdg_em_ensemble_stats(th, p, batch, wb1=wb1)  # noqa: E731
            whole_ref = lambda t_, p_, b_: em_bdg.bdg_em_ensemble_stats_reference(  # noqa: E731
                t_, p_, b_, wb1=wb1)
            estep = lambda: em_bdg.bdg_estep(th, p, batch, wb1)  # noqa: E731
            estep_ref = lambda: em_bdg.bdg_estep_reference(th, p, batch, wb1)  # noqa: E731
        else:
            plan = em_large_g.make_scatter_plan(ds.triplets, g)
            batch = make_batch(ds.triplets, ds.ratings, ds.weights, dev, scatter=plan)
            fn = em_bd.bd_em_ensemble_stats if kind == "bd" else em_large_g.large_g_ensemble_stats
            whole = lambda: fn(th, p, batch)  # noqa: E731
            whole_ref = em_bd.bd_em_ensemble_stats_reference
            estep = lambda: em_bd.em_streams(th, p, batch)  # noqa: E731
            estep_ref = lambda: em_bd.em_streams_reference(th, p, batch)  # noqa: E731
        out, ref = whole(), whole_ref(th, p, batch)
        f64 = _by_restarts(whole_ref, th.double(), p.double(), batch)
        torch.cuda.synchronize()
        _check_stats(f"{tag} {shape}", out, ref, f64)
        del out, ref, f64
        # Each kernel alone against its plain version on the same inputs.
        got_e, want_e = estep(), estep_ref()
        scatter_args = (batch.scatter_perm, batch.scatter_lid, batch.scatter_offsets,
                        em_bd.DEFAULT_WB, g, K)
        got_s = em_bd.plan_scatter(want_e[0], *scatter_args)
        want_s = em_bd.plan_scatter_reference(want_e[0], *scatter_args)
        torch.cuda.synchronize()
        e_err = _max_err(zip(got_e[:-1], want_e[:-1]))
        s_err = _max_err([(got_s, want_s)])
        e_ll = float(((got_e[-1] - want_e[-1]).abs() / want_e[-1].abs()).max())
        print(f"[{tag}] {shape}: E-step max abs err {e_err:.3e} (streams, theta_hat, "
              f"p_hat), loglik rel {e_ll:.3e}; plan_scatter max abs err {s_err:.3e}")
        assert e_ll <= LOGLIK_RTOL
        streams = want_e[0]
        del got_e, want_e, got_s, want_s
        t = {
            "kernel": _time_ms(whole, 10),
            "plain": _time_ms(lambda: whole_ref(th, p, batch), 3),
            "estep": _time_ms(estep, 10),
            "estep_plain": _time_ms(estep_ref, 3),
            "scatter": _time_ms(lambda: em_bd.plan_scatter(streams, *scatter_args), 20),
            "scatter_plain": _time_ms(
                lambda: em_bd.plan_scatter_reference(streams, *scatter_args), 3),
            "k1": _time_ms(lambda: em_bdr.em_ensemble_stats(th, p, plain_batch), 10),
        }
        # The yardstick of K5b: index_add_ of the same slots into [G, S*K].
        slots = len(positions) * N
        genes = torch.as_tensor(np.concatenate([trip[:, q] for q in positions]),
                                dtype=torch.long, device=dev)
        vals = streams.reshape(slots, S * K)
        acc = torch.zeros((g, S * K), device=dev)
        t["scatter_library"] = _time_ms(lambda: acc.index_add_(0, genes, vals), 20)
        flops = _sweep_flops(N, K, S)
        stream_b = 4.0 * slots * S * K
        bounds = {
            "estep": _bound(flops, _sweep_bytes(N, g, K, R, S, extra=stream_b + 4.0 * N)
                            if kind == "bdg" else
                            _sweep_bytes(N, g, K, R, S, extra=stream_b) - 4.0 * S * g * K),
            "scatter": _bound(float(slots * S * K),
                              stream_b + 8.0 * slots + 4.0 * S * g * K),
            "kernel": _bound(flops, _sweep_bytes(N, g, K, R, S, extra=8.0 * slots)),
        }
        print(f"[{tag}] {shape}: sweep-stats {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, K1 {t['k1']:.4f} ms; E-step {t['estep']:.4f} ms "
              f"(plain {t['estep_plain']:.4f}); plan_scatter {t['scatter']:.4f} ms "
              f"(plain {t['scatter_plain']:.4f}, index_add_ {t['scatter_library']:.4f}); "
              f"bounds {json.dumps(bounds)} ({card})")
        rec[(kind, g, S)] = dict(t, e_err=e_err, s_err=s_err, bounds=bounds)
        del st, th, p, batch, plain_batch, streams, ds, genes, vals, acc
        torch.cuda.empty_cache()

    counted = {em_bdg.ESTEP_NAME: em_bdg.bdg_estep, em_bd.SCATTER_NAME: em_bd.plan_scatter,
               em_bd.STREAMS_NAME: em_bd.em_streams, em_bdr.KERNEL_NAME: em_bdr.em_ensemble_stats,
               score.KERNEL_NAME: score.ensemble_score}

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in counted.items()}

    # 8b. the large-G job through the CLI: synth -> fit -> predict
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synth.npz")
        assert cli_main(["synth", "-o", data, "-n", str(N), "-g", "100000", "-k", str(K),
                         "--ratings", str(R), "--seed", "0"]) == 0
        out_dir = os.path.join(tmp, "fit")
        pred = os.path.join(tmp, "pred.tsv")
        reset()
        t_job = time.perf_counter()
        assert cli_main(["fit", "-f", data, "-k", str(K), "-s", "10", "-i", str(LARGE_G_SWEEPS),
                         "-n", "10", "-o", out_dir, "--device", "cuda"]) == 0
        job_s = time.perf_counter() - t_job
        assert cli_main(["predict", "-f", data, "--checkpoint",
                         os.path.join(out_dir, "model.ckpt.npz"), "-o", pred,
                         "--device", "cuda"]) == 0
        job_counts = counts()
        with open(os.path.join(out_dir, "events.jsonl")) as fh:
            events = [json.loads(line) for line in fh]
        with open(os.path.join(out_dir, "report.json")) as fh:
            report = json.load(fh)
        trace = load_checkpoint(os.path.join(out_dir, "model.ckpt.npz"))["ll_trace"]
        with open(pred) as fh:
            probs = np.array([float(line.rsplit("\t", 1)[1]) for line in fh.readlines()[1:]])
    disp = next(e for e in events if e["event"] == "dispatch")
    done = next(e for e in events if e["event"] == "fit_done")
    drop = _max_drop(trace)
    print(f"[large-G job] dispatch {json.dumps(disp, sort_keys=True)}")
    print(f"[large-G job] launches {job_counts}; L trace (best restart per check) "
          f"{trace.max(axis=1).tolist()}, largest relative L drop {drop:.3e}; AUC "
          f"{report['auc']:.4f}; fit {done['sweeps'] / done['wall_s']:.2f} sweeps/s, "
          f"{done['triplets_per_sec'] * 10:.4e} restart-triplet updates/s (S=10, "
          f"{done['sweeps']} sweeps); fit command {job_s:.2f} s ({card})")
    assert disp["kernel"] == em_bdg.KERNEL_NAME, disp
    assert job_counts[em_bdg.ESTEP_NAME] >= LARGE_G_SWEEPS
    assert job_counts[em_bd.SCATTER_NAME] >= LARGE_G_SWEEPS
    assert job_counts[score.KERNEL_NAME] >= 1
    assert trace.shape == (LARGE_G_SWEEPS // 10, 10) and np.isfinite(trace).all()
    assert drop <= LL_DROP_RTOL and np.isfinite(report["auc"])
    assert probs.shape == (N,) and probs.min() >= 0.0 and probs.max() <= 1.0

    # 8c. the bd-plan and large-G routes through fit, at full size
    route_counts = {}
    for route, g, S in ((em_bd.KERNEL_NAME, 500_000, 10), (em_large_g.KERNEL_NAME, 100_000, 1)):
        ds, _, _ = sample_synthetic_dataset(N, g, K, n_ratings=R, seed=7)
        train, _ = train_test_split(ds, 0.2, seed=0)
        cfg = Config()
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, k=K, sweeps=ROUTE_SWEEPS, samples=S, likelihood_freq=10, seed=0))
        reset()
        res = fit(cfg, train, device=dev, logger=JsonlLogger(None, echo=False))
        route_counts[route] = counts()
        drop = _max_drop(res.ll_trace)
        print(f"[{route} fit] G={g}, S={S}: kernel {res.dispatch['kernel']}, launches "
              f"{route_counts[route]}, {res.sweeps_run / res.wall_seconds:.2f} sweeps/s, "
              f"{res.triplets_per_sec * S:.4e} restart-triplet updates/s, largest "
              f"relative L drop {drop:.3e} ({card})")
        assert res.dispatch["kernel"] == route, res.dispatch
        assert route_counts[route][em_bd.STREAMS_NAME] >= ROUTE_SWEEPS
        assert route_counts[route][em_bd.SCATTER_NAME] >= ROUTE_SWEEPS
        assert drop <= LL_DROP_RTOL and np.isfinite(res.final_loglik).all()
        del ds, train, res
        torch.cuda.empty_cache()

    # 8d. a small fit through each new route against the plain fit
    small, _, _ = sample_synthetic_dataset(4096, 6000, K, n_ratings=R, seed=8)
    quiet = JsonlLogger(None, echo=False)
    for route in (em_bdg.KERNEL_NAME, em_bd.KERNEL_NAME, em_large_g.KERNEL_NAME):
        cfg = Config()
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, k=K, sweeps=20, samples=1 if route == em_large_g.KERNEL_NAME else 4,
            likelihood_freq=5, seed=5))
        via_kernel = fit(cfg, small, device=dev, logger=quiet,
                         stats_fn=dispatch.stats_fn_for(route, K, R))
        via_plain = fit(cfg, small, device=dev, logger=quiet, stats_fn=dispatch.plain_stats)
        assert via_kernel.dispatch["kernel"] == route
        np.testing.assert_allclose(via_kernel.final_loglik, via_plain.final_loglik,
                                   rtol=FIT_RTOL)
        print(f"[{route}] small fit (G=6000), kernel vs plain final L within rtol "
              f"{FIT_RTOL:g}: {via_kernel.final_loglik.tolist()} vs "
              f"{via_plain.final_loglik.tolist()}")

    src = "trigenicinteractionpredictor_tpu_torch/csrc/"
    ref = "trigenicinteractionpredictor_tpu/ops/"
    bdg, bd, s1 = rec[("bdg", 100_000, 10)], rec[("bd", 500_000, 10)], rec[("large", 100_000, 1)]
    bd_n, lg_n = route_counts[em_bd.KERNEL_NAME], route_counts[em_large_g.KERNEL_NAME]
    def row(name, source, replaces, launches, err, r, part, plain, library=None):
        bound_ms, bound_by = r["bounds"][part]
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": ref + replaces, "launches": launches, "max_abs_err": err,
                "ms": r[part], "plain_ms": r[plain], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library}

    return [
        row("em_bdg", "em_bdg.cu", "pallas_em_bdg.py:289", job_counts[em_bdg.ESTEP_NAME],
            bdg["e_err"], bdg, "estep", "estep_plain"),
        row("plan_scatter", "plan_scatter.cu", "pallas_em_bd.py:364",
            job_counts[em_bd.SCATTER_NAME] + bd_n[em_bd.SCATTER_NAME],
            max(r["s_err"] for r in rec.values()), bdg, "scatter", "scatter_plain",
            bdg["scatter_library"]),
        row("em_streams", "em_sweep.cu", "pallas_em_bd.py:215", bd_n[em_bd.STREAMS_NAME],
            bd["e_err"], bd, "estep", "estep_plain"),
        row("large_g (em_streams + plan_scatter at S = 1)", "em_sweep.cu",
            "pallas_em_large.py:275", lg_n[em_bd.STREAMS_NAME], max(s1["e_err"], s1["s_err"]),
            s1, "kernel", "plain"),
    ]


def stepwise_phase(card: str, dev, cli_main):
    """Phase 9 (see the module docstring); returns K7's record for the
    kernels line and the K1 and K2 launches of the stepwise paths."""
    import numpy as np
    import torch

    from trigenicinteractionpredictor_tpu_torch import Config
    from trigenicinteractionpredictor_tpu_torch.data import (
        TripletDataset,
        sample_synthetic_dataset,
        train_test_split,
    )
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu_torch.ops import (
        dispatch,
        em_bdr,
        em_hybrid,
        em_large_k,
        score,
    )
    from trigenicinteractionpredictor_tpu_torch.ops.em import Batch, log_likelihood, make_batch
    from trigenicinteractionpredictor_tpu_torch.ops.stepwise import stepwise_group, zero_stats_like
    from trigenicinteractionpredictor_tpu_torch.train.checkpoint import load_checkpoint
    from trigenicinteractionpredictor_tpu_torch.train.stream_prep import StreamPrep
    from trigenicinteractionpredictor_tpu_torch.train.trainer import JsonlLogger, fit

    R, MB = 2, STEPWISE_MB
    quiet = JsonlLogger(None, echo=False)
    rec = {}

    # 9a. K7 against its plain version and float64, with K3's time beside it
    for k, g, S in K7_SHAPES:
        shape = f"N={MB}, G={g}, K={k}, R={R}, S={S}"
        ds, _, _ = sample_synthetic_dataset(MB, g, 10, n_ratings=R, seed=9)
        st = init_state(g, k, R, samples=S, seed=10, device=dev)
        batch = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
        streams = em_hybrid.gather_rows(st.theta, batch.triplets)
        rows = (batch.triplets, batch.ratings, batch.weights)
        out = em_hybrid.hybrid_stats(*streams, *rows, st.p, g)
        ref = em_hybrid.em_ensemble_stats_reference(*streams, *rows, st.p, g)
        f64 = em_hybrid.em_ensemble_stats_reference(
            *(x.double() for x in streams), *rows, st.p.double(), g, row_chunk=4096)
        torch.cuda.synchronize()
        err = _check_stats(f"K7 {shape}", out, ref, f64)
        del out, ref, f64
        t = {
            "kernel": _time_ms(lambda: em_hybrid.hybrid_stats(*streams, *rows, st.p, g), 10),
            "route": _time_ms(lambda: em_hybrid.em_ensemble_stats(st.theta, st.p, batch), 10),
            "plain": _time_ms(
                lambda: em_hybrid.em_ensemble_stats_reference(*streams, *rows, st.p, g), 3),
            "k3": _time_ms(lambda: em_large_k.em_ensemble_stats(st.theta, st.p, batch), 10),
        }
        bound = _bound(_sweep_flops(MB, k, S),
                       _sweep_bytes(MB, g, k, R, S, theta_in=3 * 4.0 * MB * S * k))
        print(f"[K7] {shape}: {t['kernel']:.4f} ms (with the gather {t['route']:.4f}), "
              f"plain {t['plain']:.4f} ms, K3 {t['k3']:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}) ({card})")
        rec[(k, g, S)] = dict(t, err=err, bound=bound)
        del st, batch, streams, rows, ds
        torch.cuda.empty_cache()

    counted = {em_hybrid.KERNEL_NAME: em_hybrid.hybrid_stats,
               em_bdr.KERNEL_NAME: em_bdr.em_ensemble_stats,
               em_large_k.KERNEL_NAME: em_large_k.em_ensemble_stats,
               score.KERNEL_NAME: score.ensemble_score}

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in counted.items()}

    # 9b. the stepwise fit through the CLI on the K7 route, then predict
    K, S, G = 25, 2, 6000
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synth.npz")
        assert cli_main(["synth", "-o", data, "-n", str(STEPWISE_N), "-g", str(G),
                         "-k", str(K), "--ratings", str(R), "--seed", "0"]) == 0
        out_dir = os.path.join(tmp, "fit")
        pred = os.path.join(tmp, "pred.tsv")
        reset()
        t_job = time.perf_counter()
        assert cli_main(["fit", "-f", data, "-k", str(K), "-s", str(S), "-i", "3", "-n", "1",
                         "--minibatch", str(MB), "--stream-groups", "4", "-o", out_dir,
                         "--device", "cuda"]) == 0
        job_s = time.perf_counter() - t_job
        assert cli_main(["predict", "-f", data, "--checkpoint",
                         os.path.join(out_dir, "model.ckpt.npz"), "-o", pred,
                         "--device", "cuda"]) == 0
        job_counts = counts()
        with open(os.path.join(out_dir, "events.jsonl")) as fh:
            events = [json.loads(line) for line in fh]
        ck = load_checkpoint(os.path.join(out_dir, "model.ckpt.npz"), dev)
        with open(pred) as fh:
            probs = np.array([float(line.rsplit("\t", 1)[1]) for line in fh.readlines()[1:]])
        train, _ = train_test_split(TripletDataset.load_npz(data), 0.2, seed=0)
    tb = make_batch(train.triplets, train.ratings, train.weights, dev)
    l_init = log_likelihood(init_state(G, K, R, samples=S, seed=0, device=dev), tb,
                            row_chunk=16384).cpu().numpy()
    l_final = log_likelihood(ck["states"], tb, row_chunk=16384).cpu().numpy()
    disp = next(e for e in events if e["event"] == "dispatch")
    layout = next(e for e in events if e["event"] == "stepwise")
    done = next(e for e in events if e["event"] == "fit_done")
    trace = ck["ll_trace"]
    print(f"[stepwise job] dispatch {json.dumps(disp, sort_keys=True)}; layout "
          f"minibatch {layout['minibatch']}, {layout['n_minibatches']} minibatches, "
          f"stream_groups {layout['stream_groups']}, padded rows {layout['padded_rows']}, "
          f"prep workers {layout['prep_workers']}")
    print(f"[stepwise job] launches {job_counts}; epoch trace (best restart) "
          f"{trace.max(axis=1).tolist()}; L on the train split {l_init.tolist()} -> "
          f"{l_final.tolist()}; {done['sweeps'] / done['wall_s']:.3f} epochs/s, "
          f"{done['triplets_per_sec']:.4e} rows/s ({done['triplets_per_sec'] * S:.4e} "
          f"restart-row updates/s, S={S}); fit command {job_s:.2f} s ({card})")
    assert disp["kernel"] == em_hybrid.KERNEL_NAME, disp
    assert done["mode"] == "stepwise" and done["sweeps"] == 3
    assert job_counts[em_hybrid.KERNEL_NAME] == 3 * layout["n_minibatches"], job_counts
    assert job_counts[score.KERNEL_NAME] >= 1
    assert trace.shape == (3, S) and np.isfinite(trace).all()
    assert np.isfinite(l_final).all() and np.all(l_final > l_init), (l_init, l_final)
    assert probs.shape == (STEPWISE_N,) and probs.min() >= 0.0 and probs.max() <= 1.0
    del tb, train, ck

    # 9c. the streaming job: a 10^7-row memmapped store through fit, on K1
    K, S, G = 10, 10, 1000
    with tempfile.TemporaryDirectory() as tmp:
        t_make = time.perf_counter()
        ds, _, _ = sample_synthetic_dataset(STREAM_N, G, K, n_ratings=R, seed=11)
        ds.save_dir(os.path.join(tmp, "store"))
        del ds
        store = TripletDataset.load_dir(os.path.join(tmp, "store"), mmap=True)
        make_s = time.perf_counter() - t_make
        cfg = Config()
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, k=K, sweeps=STREAM_EPOCHS, samples=S, likelihood_freq=1, seed=0,
            minibatch=MB, stream_groups=STREAM_GROUPS))
        reset()
        res = fit(cfg, store, device=dev, logger=quiet)
        stream_counts = counts()
        lay = res.layout
        n_mb = lay["n_minibatches"]
        group = lay["stream_groups"] or n_mb
        assert res.dispatch["kernel"] == em_bdr.KERNEL_NAME, res.dispatch
        assert stream_counts[em_bdr.KERNEL_NAME] == STREAM_EPOCHS * n_mb, stream_counts
        assert res.ll_trace.shape == (STREAM_EPOCHS, S) and np.isfinite(res.ll_trace).all()
        assert np.isfinite(res.final_loglik).all()

        # One epoch's parts, measured apart (not counted): host prep (the
        # pool the fit used), the copy into pinned memory, the host-to-device
        # copy, the device work of the groups, and K1 alone.
        prep = StreamPrep(store, {"seed": 0, "n": store.n_rows, "n_padded": lay["padded_rows"],
                                  "mb": MB, "mb_b": MB, "group": group, "arity": 3,
                                  "rsort": False, "n_ratings": R, "tile": 0, "n_shards": 1,
                                  "n_tiles": 0}, workers=0)
        prep_s = pin_s = 0.0
        pinned = []
        try:
            for d in range(n_mb // group):
                t0 = time.perf_counter()
                host = prep.prep_group(0, d)
                t1 = time.perf_counter()
                pinned.append([torch.from_numpy(np.array(host[k])).pin_memory()
                               for k in ("trip", "rat", "wts")])
                pin_s += time.perf_counter() - t1
                prep_s += t1 - t0
        finally:
            prep.close()
        inline = StreamPrep(store, prep._layout, workers=1)
        t0 = time.perf_counter()
        try:
            for d in range(n_mb // group):
                inline.prep_group(0, d)
        finally:
            inline.close()
        inline_s = time.perf_counter() - t0
        on_dev = []
        h2d_ms = _time_ms(lambda: on_dev.append(
            [Batch(*(x.to(dev, non_blocking=True) for x in grp)) for grp in pinned]), 1)
        groups = on_dev[-1]
        del on_dev[:-1]
        st = init_state(G, K, R, samples=S, seed=0, device=dev)
        degrees = torch.as_tensor(store.degrees(), device=dev)
        w_total = torch.tensor(np.float32(store.weight_total()), device=dev)

        def epoch():
            states, ema, t = st, zero_stats_like(st), torch.zeros((), device=dev)
            for grp in groups:
                states, ema, _, t = stepwise_group(states, ema, t, grp, degrees, w_total,
                                                   em_bdr.em_ensemble_stats, 0.6, 2.0)

        device_ms = _time_ms(epoch, 1)
        minibatches = [Batch(grp.triplets[i], grp.ratings[i], grp.weights[i])
                       for grp in groups for i in range(group)]
        kernel_ms = _time_ms(lambda: [em_bdr.em_ensemble_stats(st.theta, st.p, mb)
                                      for mb in minibatches], 1)
        n_workers = prep.workers
        del store, groups, minibatches, pinned, st
    print(f"[streaming job] {STREAM_N} rows (store made in {make_s:.2f} s), G={G}, K={K}, "
          f"S={S}, {n_mb} minibatches of {MB} in groups of {group}, {STREAM_EPOCHS} epochs: "
          f"launches {stream_counts}; epoch trace (best) {res.ll_trace.max(axis=1).tolist()}")
    print(f"[streaming job] per epoch: wall {res.wall_seconds / STREAM_EPOCHS:.4f} s; host "
          f"prep {prep_s:.4f} s ({n_workers} workers; in-thread {inline_s:.4f} s), copy into "
          f"pinned memory {pin_s:.4f} s, "
          f"host-to-device {h2d_ms / 1e3:.4f} s, device {device_ms / 1e3:.4f} s of which K1 "
          f"{kernel_ms / 1e3:.4f} s ({n_mb} launches); {res.triplets_per_sec:.4e} rows/s "
          f"({res.triplets_per_sec * S:.4e} restart-row updates/s) ({card})")

    # 9d. a small stepwise fit through each route against the plain route's
    small, _, _ = sample_synthetic_dataset(20_000, 6000, 5, n_ratings=R, seed=12)
    for route, k in ((em_bdr.KERNEL_NAME, 10), (em_large_k.KERNEL_NAME, 25),
                     (em_hybrid.KERNEL_NAME, 25)):
        cfg = Config()
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, k=k, sweeps=3, samples=2, likelihood_freq=1, seed=5, minibatch=4096,
            stream_groups=2))
        via_kernel = fit(cfg, small, device=dev, logger=quiet,
                         stats_fn=dispatch.stats_fn_for(route, k, R))
        via_plain = fit(cfg, small, device=dev, logger=quiet, stats_fn=dispatch.plain_stats)
        assert via_kernel.dispatch["kernel"] == route
        np.testing.assert_allclose(via_kernel.final_loglik, via_plain.final_loglik,
                                   rtol=FIT_RTOL)
        np.testing.assert_allclose(via_kernel.ll_trace, via_plain.ll_trace, rtol=FIT_RTOL)
        print(f"[{route}] small stepwise fit (G=6000, K={k}), kernel vs plain final L within "
              f"rtol {FIT_RTOL:g}: {via_kernel.final_loglik.tolist()} vs "
              f"{via_plain.final_loglik.tolist()}")

    first = rec[K7_SHAPES[0]]
    k7 = {
        "name": "em_hybrid", "route": "cuda",
        "source": "trigenicinteractionpredictor_tpu_torch/csrc/em_hybrid.cu",
        "replaces": "trigenicinteractionpredictor_tpu/ops/pallas_em_hybrid.py:161",
        "launches": job_counts[em_hybrid.KERNEL_NAME],
        "max_abs_err": max(r["err"] for r in rec.values()),
        "ms": first["kernel"], "plain_ms": first["plain"], "bound_ms": first["bound"][0],
        "bound_by": first["bound"][1], "library_ms": None,
    }
    return k7, {em_bdr.KERNEL_NAME: stream_counts[em_bdr.KERNEL_NAME],
                score.KERNEL_NAME: job_counts[score.KERNEL_NAME]}


def _launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from trigenicinteractionpredictor_tpu_torch.ops import (
        block_sum,
        em_bd,
        em_bdg,
        em_bdr,
        em_hybrid,
        em_large_k,
        em_rsorted,
        score,
    )

    return {fn.kernel_name: fn for fn in (
        em_bdr.em_ensemble_stats, em_large_k.em_ensemble_stats, em_hybrid.hybrid_stats,
        em_bdg.bdg_estep, em_bd.em_streams, em_bd.plan_scatter, score.ensemble_score,
        em_rsorted.rsorted_em_ensemble_stats, block_sum.block_sum)}


def sentinel_phase(card: str, dev) -> None:
    """Phase 2b (see the module docstring)."""
    from trigenicinteractionpredictor_tpu_torch.utils import integrity

    counters = _launch_counters()

    def launches():
        return sum(fn.launches for fn in counters.values())

    with tempfile.TemporaryDirectory() as tmp:
        integrity.CACHE_PATH = os.path.join(tmp, "verdicts.json")
        integrity.clear_cache()
        runs = integrity.probe_runs
        t0 = time.perf_counter()
        assert integrity.check_em_integrity(dev, 3)
        first_s = time.perf_counter() - t0
        for r in integrity.last_probes:
            print(f"[sentinel] {r.name} {r.kernel} ({r.shape}): max err / scale {r.err:.3e} "
                  f"(tol {integrity._TOL:g}), {r.ms:.3f} ms ({card})")
        assert integrity.probe_runs == runs + 1
        assert len(integrity.last_probes) == 8 and all(r.ok for r in integrity.last_probes)
        before = launches()
        t0 = time.perf_counter()
        assert integrity.check_em_integrity(dev, 3)
        cached_s = time.perf_counter() - t0
        integrity.clear_cache()
        t0 = time.perf_counter()
        assert integrity.check_em_integrity(dev, 3)
        disk_s = time.perf_counter() - t0
        assert launches() == before and integrity.probe_runs == runs + 1
        print(f"[sentinel] first call {first_s:.3f} s (probes and their CPU references); "
              f"in-process cache hit {cached_s * 1e3:.4f} ms, disk cache hit "
              f"{disk_s * 1e3:.3f} ms, no launch ({card})")

        # A corrupt kernel output fails its probe, and the check refuses it.
        scaled = lambda out: out._replace(theta_hat=out.theta_hat * 0.9)  # noqa: E731
        k1 = next(p for p in integrity.probes(3) if p.name == "K1")
        bad = integrity.run_probe(k1, dev, tamper=scaled)
        print(f"[sentinel] K1 with theta_hat x 0.9: ok={bad.ok}, max err / scale {bad.err:.3e}")
        assert not bad.ok
        # The same corruption inside check_em_integrity (its K1 probe's
        # output scaled), with a verdict cache of its own: refused.
        real_probes, good_cache = integrity.probes, integrity.CACHE_PATH

        def corrupted(*args, **kwargs):
            return [p._replace(run=lambda d, sh, _, run=p.run: run(d, sh, scaled))
                    if p.name == "K1" else p for p in real_probes(*args, **kwargs)]

        try:
            integrity.probes = corrupted
            integrity.CACHE_PATH = os.path.join(tmp, "corrupt.json")
            integrity.clear_cache()
            try:
                integrity.check_em_integrity(dev, 3)
            except integrity.ComputeIntegrityError as exc:
                print(f"[sentinel] refused: {exc}")
                assert "K1 (" in str(exc) and "over tolerance" in str(exc), exc
            else:
                raise AssertionError("the sentinel passed a corrupt K1")
            assert [r.name for r in integrity.last_probes if not r.ok] == ["K1"]
        finally:
            integrity.probes, integrity.CACHE_PATH = real_probes, good_cache
            integrity.clear_cache()
        # Leave the PASS verdict in the in-process cache for later fits.
        runs = integrity.probe_runs
        assert integrity.check_em_integrity(dev, 3) and integrity.probe_runs == runs


def rsorted_phase(card: str, dev, ds, train, k1_fit) -> dict:
    """Phase 10 (see the module docstring); ``ds`` and ``train`` are phase
    3's rows and phase 6's split, ``k1_fit`` phase 6's fit.  Returns K9's
    record for the kernels line."""
    import numpy as np
    import torch

    from trigenicinteractionpredictor_tpu_torch import Config
    from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu_torch.ops import em_bdr, em_large_k, em_rsorted
    from trigenicinteractionpredictor_tpu_torch.ops.em import make_batch
    from trigenicinteractionpredictor_tpu_torch.train.trainer import JsonlLogger, fit

    N, G, K, R, S = (HEADLINE[k] for k in ("n", "genes", "k", "ratings", "samples"))
    k9 = em_rsorted.rsorted_em_ensemble_stats
    quiet = JsonlLogger(None, echo=False)
    rec = {}

    # 10a. K9 against its plain version and float64, with K1 (K3) beside it
    plan = em_rsorted.rating_sort_pad(ds.ratings, R, tile=RSORT_TILE)
    trip, rat, w = em_rsorted.apply_rating_sort(plan, ds.triplets, ds.ratings, ds.weights)
    batch = make_batch(trip, rat, w, dev, tile_rating=plan.tile_r)
    unsorted = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    n_real = int((ds.weights > 0).sum())
    for k in (K, em_rsorted.MAX_K):
        shape = f"N={N} (plan {plan.n_rows}), G={G}, K={k}, R={R}, S={S}, tile {RSORT_TILE}"
        st = init_state(G, k, R, samples=S, seed=1, device=dev)
        chunk = 0 if k == K else 16_384
        out = k9(st.theta, st.p, batch, RSORT_TILE)
        ref = em_rsorted.rsorted_em_ensemble_stats_reference(
            st.theta, st.p, batch, RSORT_TILE, row_chunk=chunk)
        f64 = em_rsorted.rsorted_em_ensemble_stats_reference(
            st.theta.double(), st.p.double(), batch, RSORT_TILE, row_chunk=4096)
        torch.cuda.synchronize()
        err = _check_stats(f"K9 {shape}", out, ref, f64)
        del out, ref, f64
        other = em_bdr if k == K else em_large_k
        t = {
            "kernel": _time_ms(lambda: k9(st.theta, st.p, batch, RSORT_TILE), 20 if k == K else 5),
            "plain": _time_ms(lambda: em_rsorted.rsorted_em_ensemble_stats_reference(
                st.theta, st.p, batch, RSORT_TILE, row_chunk=chunk), 3),
            "unsorted": _time_ms(lambda: other.em_ensemble_stats(st.theta, st.p, unsorted),
                                 20 if k == K else 5),
        }
        # bytes: theta, p, the plan's rows (3 ids and a weight each) and its
        # tile table in, the stats out; operations: the real rows' sweep
        bound = _bound(_sweep_flops(n_real, k, S),
                       _sweep_bytes(plan.n_rows, G, k, R, S) - 4.0 * plan.n_rows
                       + 4.0 * plan.tile_r.size)
        print(f"[K9] {shape}: {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"{other.KERNEL_NAME} on the rows unsorted {t['unsorted']:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}) ({card})")
        rec[k] = dict(t, err=err, bound=bound)
        del st
    del batch, unsorted
    torch.cuda.empty_cache()
    counters = _launch_counters()

    def reset():
        for fn in counters.values():
            fn.launches = 0

    # 10b. the classic fit through K9 at the headline shape, phase 6's seed
    sweeps = 50
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, k=K, sweeps=sweeps, samples=S, likelihood_freq=10, seed=0))
    reset()
    res = fit(cfg, train, device=dev, logger=quiet, stats_fn=em_rsorted.stats_fn(RSORT_TILE))
    classic = {name: fn.launches for name, fn in counters.items() if fn.launches}
    drop = _max_drop(res.ll_trace)
    print(f"[K9 fit] dispatch {json.dumps(res.dispatch, sort_keys=True)}; launches {classic}")
    print(f"[K9 fit] L trace (best restart) {res.ll_trace.max(axis=1).tolist()}, largest "
          f"relative L drop {drop:.3e}; final L {res.final_loglik.tolist()} vs K1's "
          f"{k1_fit.final_loglik.tolist()}; {res.sweeps_run / res.wall_seconds:.2f} sweeps/s "
          f"(K1 {k1_fit.sweeps_run / k1_fit.wall_seconds:.2f}), "
          f"{res.triplets_per_sec * S:.4e} restart-triplet updates/s ({card})")
    assert res.dispatch["kernel"] == em_rsorted.KERNEL_NAME and res.dispatch["tile_b"] == RSORT_TILE
    assert classic == {em_rsorted.KERNEL_NAME: sweeps, BLOCK_SUM: sweeps}, classic
    assert res.ll_trace.shape == (sweeps // 10, S) and np.isfinite(res.ll_trace).all()
    assert drop <= LL_DROP_RTOL
    np.testing.assert_allclose(res.final_loglik, k1_fit.final_loglik, rtol=FIT_RTOL)

    # 10c. a stepwise fit through K9 against the same fit on K1
    big, _, _ = sample_synthetic_dataset(STEPWISE_N, G, K, n_ratings=R, seed=13)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, sweeps=2, likelihood_freq=1, minibatch=STEPWISE_MB, stream_groups=4))
    reset()
    sw = fit(cfg, big, device=dev, logger=quiet, stats_fn=em_rsorted.stats_fn(RSORT_TILE))
    stepwise = {name: fn.launches for name, fn in counters.items() if fn.launches}
    on_k1 = fit(cfg, big, device=dev, logger=quiet, stats_fn=em_bdr.em_ensemble_stats)
    print(f"[K9 stepwise] N={STEPWISE_N}, G={G}, K={K}, S={S}: layout "
          f"{json.dumps(sw.layout, sort_keys=True)}; launches {stepwise}; epoch trace (best) "
          f"{sw.ll_trace.max(axis=1).tolist()}; final L {sw.final_loglik.tolist()} vs K1's "
          f"{on_k1.final_loglik.tolist()}; {sw.triplets_per_sec:.4e} rows/s (K1 "
          f"{on_k1.triplets_per_sec:.4e}) ({card})")
    n_mb = sw.layout["n_minibatches"]
    assert sw.layout["rsort_padded_mb"] == (STEPWISE_MB // RSORT_TILE + R) * RSORT_TILE
    assert stepwise == {em_rsorted.KERNEL_NAME: 2 * n_mb, BLOCK_SUM: 2 * n_mb}, stepwise
    assert 2 * n_mb == 16
    np.testing.assert_allclose(sw.final_loglik, on_k1.final_loglik, rtol=FIT_RTOL)
    del big

    head = rec[K]
    return {
        "name": "em_rsorted", "route": "cuda",
        "source": "trigenicinteractionpredictor_tpu_torch/csrc/em_rsorted.cu",
        "replaces": "trigenicinteractionpredictor_tpu/ops/pallas_em_rsorted.py:267",
        "launches": classic[em_rsorted.KERNEL_NAME] + stepwise[em_rsorted.KERNEL_NAME],
        "max_abs_err": max(r["err"] for r in rec.values()),
        "ms": head["kernel"], "plain_ms": head["plain"], "bound_ms": head["bound"][0],
        "bound_by": head["bound"][1], "library_ms": None,
    }


def _events(out_dir: str) -> list:
    with open(os.path.join(out_dir, "events.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _cpu_model() -> str:
    """The host CPU's model name (lscpu), with its core count."""
    import platform

    out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    names = [line.split(":", 1)[1].strip() for line in out.splitlines()
             if line.startswith("Model name")]
    return f"{names[0] if names else platform.machine()}, {os.cpu_count()} cores"


def quality_phase(card: str, dev, cli_main, ds, train, k1_fit) -> dict:
    """Phase 11 (see the module docstring); ``ds`` and ``train`` are phase
    3's rows and phase 6's split, ``k1_fit`` phase 6's fit.  Returns the
    main-path launches of K1 and K2 in this phase."""
    import numpy as np
    import torch

    from trigenicinteractionpredictor_tpu_torch.config import DataConfig
    from trigenicinteractionpredictor_tpu_torch.data import (
        TripletDataset,
        kuzmin,
        load_kuzmin_tsv,
        write_kuzmin_like_tsv,
    )
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu_torch.native import binding
    from trigenicinteractionpredictor_tpu_torch.ops import em_bdr, em_large_k, score
    from trigenicinteractionpredictor_tpu_torch.ops.dispatch import plain_stats
    from trigenicinteractionpredictor_tpu_torch.ops.em import make_batch
    from trigenicinteractionpredictor_tpu_torch.train.checkpoint import load_checkpoint
    from trigenicinteractionpredictor_tpu_torch.train.trainer import fit

    N, G, K, R, S = (HEADLINE[k] for k in ("n", "genes", "k", "ratings", "samples"))
    counters = _launch_counters()
    launched = {em_bdr.KERNEL_NAME: 0, score.KERNEL_NAME: 0}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in counters.items() if fn.launches}

    # 11a. K1 and K3 on powered states against plain and float64
    batch = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    for k, mod in ((K, em_bdr), (50, em_large_k)):
        st = init_state(G, k, R, samples=S, seed=21, device=dev)
        th, p = st.theta ** ANNEAL_BETA, st.p ** ANNEAL_BETA
        d_max = float(th.sum(-1).max()) ** 3 * float(p.sum(-1).max())
        out = mod.em_ensemble_stats(th, p, batch)
        ref = mod.em_ensemble_stats_reference(th, p, batch)
        f64 = mod.em_ensemble_stats_reference(th.double(), p.double(), batch,
                                              **({"row_chunk": 4096} if k > 20 else {}))
        torch.cuda.synchronize()
        _check_stats(f"{mod.KERNEL_NAME} K={k} on (theta^{ANNEAL_BETA}, p^{ANNEAL_BETA})",
                     out, ref, f64)
        del out, ref, f64
        ms = _time_ms(lambda: mod.em_ensemble_stats(th, p, batch), 20 if k == K else 5)
        unpowered = _time_ms(lambda: mod.em_ensemble_stats(st.theta, st.p, batch),
                             20 if k == K else 5)
        print(f"[anneal] {mod.KERNEL_NAME} K={k}: {ms:.4f} ms on powered states, {unpowered:.4f} "
              f"ms on the simplex (N={N}, G={G}, R={R}, S={S}; D_beta up to {d_max:.4g}; {card})")
        del st, th, p
    del batch
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        data = ds.save_npz(os.path.join(tmp, "phase6.npz"))
        base = ["fit", "-f", data, "-k", str(K), "-s", str(S), "-n", "10", "--device", "cuda"]

        # 11b. the annealed fit through the CLI
        out_b = os.path.join(tmp, "anneal")
        reset()
        assert cli_main(base + ["-i", "50", "-o", out_b, "--anneal-beta0", str(ANNEAL_BETA),
                                "--anneal-sweeps", "20"]) == 0
        run_b = counts()
        ev_b = _events(out_b)
        trace_b = load_checkpoint(os.path.join(out_b, "model.ckpt.npz"))["ll_trace"]

        # 11c. the spectral-init fit through the CLI
        out_c = os.path.join(tmp, "spectral")
        reset()
        assert cli_main(base + ["-i", "50", "-o", out_c, "--init", "spectral"]) == 0
        run_c = counts()
        ev_c = _events(out_c)
        trace_c = load_checkpoint(os.path.join(out_c, "model.ckpt.npz"))["ll_trace"]

        # 11d. split-merge and refine rounds through the CLI
        out_d = os.path.join(tmp, "rounds")
        reset()
        assert cli_main(base + ["-i", "40", "-o", out_d, "--smem-rounds", "2",
                                "--smem-sweeps", "10", "--refine-rounds", "2",
                                "--refine-sweeps", "10"]) == 0
        run_d = counts()
        ev_d = _events(out_d)
        with open(os.path.join(out_d, "report.json")) as fh:
            report_d = json.load(fh)

    disp = next(e for e in ev_b if e["event"] == "dispatch")
    done = next(e for e in ev_b if e["event"] == "fit_done")
    anneal = [e for e in ev_b if e["event"] == "anneal"]
    freq = 10
    first = (20 + 2 * freq) // freq - 1  # the row of the check at anneal_end + 2 freq
    drop = _max_drop(trace_b[first:])
    print(f"[anneal fit] dispatch {json.dumps(disp, sort_keys=True)}; launches {run_b}; "
          f"{json.dumps(anneal)}; L trace (best restart) {trace_b.max(axis=1).tolist()} "
          f"(annealed objective before sweep 20); largest relative L drop from sweep "
          f"{(first + 1) * freq} {drop:.3e}")
    print(f"[anneal fit] {done['sweeps'] / done['wall_s']:.2f} sweeps/s, "
          f"{done['triplets_per_sec'] * S:.4e} restart-triplet updates/s; phase 6's plain "
          f"fit {k1_fit.sweeps_run / k1_fit.wall_seconds:.2f} sweeps/s ({card})")
    assert disp["kernel"] == em_bdr.KERNEL_NAME, disp
    assert run_b.get(em_bdr.KERNEL_NAME, 0) >= 50, run_b
    assert anneal and anneal[0]["ramp_sweeps"] == 20 and anneal[0]["beta0"] == ANNEAL_BETA
    assert drop <= LL_DROP_RTOL and np.isfinite(done["ll_best"]) and np.isfinite(trace_b).all()

    init = next(e for e in ev_c if e["event"] == "init")
    done_c = next(e for e in ev_c if e["event"] == "fit_done")
    print(f"[spectral fit] init on the host {init['seconds']:.4f} s ({init['method']}, "
          f"S={init['samples']}; host CPU {_cpu_model()}), fit {done_c['wall_s']:.4f} s, "
          f"{done_c['sweeps'] / done_c['wall_s']:.2f} sweeps/s ({card}); launches {run_c}; "
          f"best L at each check {trace_c.max(axis=1).tolist()} (random init, phase 6: "
          f"{k1_fit.ll_trace.max(axis=1).tolist()})")
    assert init["method"] == "spectral" and run_c.get(em_bdr.KERNEL_NAME, 0) >= 50, run_c
    assert np.isfinite(trace_c).all() and _max_drop(trace_c) <= LL_DROP_RTOL

    names = [e["event"] for e in ev_d]
    rounds = [e for e in ev_d if e["event"] in ("smem", "smem_done", "refine", "refine_done")]
    for e in rounds:
        print(f"[rounds] {e['event']} round {e['round']}: " + ", ".join(
            f"{key} {e[key]}" for key in ("from_ll", "to_ll", "accepted_move") if key in e))
    main_best = next(e["from_ll"] for e in rounds if e["event"] == "smem")
    done_d = [e for e in ev_d if e["event"] == "fit_done"][-1]  # the whole fit's
    print(f"[rounds] launches {run_d}; sweeps {report_d['sweeps']}; best final L "
          f"{report_d['ll_best']} against the 40-sweep main fit's {main_best}; "
          f"{done_d['sweeps'] / done_d['wall_s']:.2f} sweeps/s, "
          f"{done_d['triplets_per_sec'] * S:.4e} restart-triplet updates/s over the main "
          f"fit and its rounds ({card})")
    assert run_d.get(em_bdr.KERNEL_NAME, 0) >= 80, run_d
    assert report_d["sweeps"] == 80
    assert [n for n in names if n in ("smem", "smem_done", "refine", "refine_done")] == [
        "smem", "smem_done", "smem", "smem_done", "refine", "refine_done", "refine",
        "refine_done"]
    assert report_d["ll_best"] >= main_best - FIT_RTOL * abs(main_best)
    print(f"[knobs] CLI fits at the headline shape: annealed {done['sweeps'] / done['wall_s']:.2f}"
          f", spectral init (no annealing) {done_c['sweeps'] / done_c['wall_s']:.2f}, 40 + 4 x 10 "
          f"rounds {done_d['sweeps'] / done_d['wall_s']:.2f} sweeps/s ({card})")
    for run in (run_b, run_c, run_d):
        launched[em_bdr.KERNEL_NAME] += run.get(em_bdr.KERNEL_NAME, 0)

    # 11e. a small fit with all four knobs, kernel against plain (not counted)
    small, cfg = _four_knob_fit()
    ev_kernel, ev_plain = _Events(), _Events()
    via_kernel = fit(cfg, small, device=dev, logger=ev_kernel)
    via_plain = fit(cfg, small, device=dev, logger=ev_plain, stats_fn=plain_stats)
    done_rounds = [[(e, f.get("to_ll"), f.get("accepted_move")) for e, f in ev.events
                    if e in ("smem_done", "refine_done")] for ev in (ev_kernel, ev_plain)]
    print(f"[knobs] small fit (G=200, N=4096, S=4, all four knobs): kernel "
          f"{via_kernel.final_loglik.tolist()} {done_rounds[0]}; plain "
          f"{via_plain.final_loglik.tolist()} {done_rounds[1]}")
    assert via_kernel.dispatch["kernel"] == em_bdr.KERNEL_NAME
    assert via_kernel.sweeps_run == via_plain.sweeps_run == 40
    # An accepted round patches the worst lane (argmin).  The main fit's lanes
    # converge to one optimum from the spectral init, so that argmin falls
    # among lanes equal to float32 rounding, and the patched lane's index
    # differs from run to run on either route.  The lanes are exchangeable:
    # compare them as a set, with the best L and every round's L as they are.
    np.testing.assert_allclose(np.sort(via_kernel.final_loglik),
                               np.sort(via_plain.final_loglik), rtol=FIT_RTOL)
    np.testing.assert_allclose([ll for _, ll, _ in done_rounds[0]],
                               [ll for _, ll, _ in done_rounds[1]], rtol=FIT_RTOL)
    assert [m for _, _, m in done_rounds[0]] == [m for _, _, m in done_rounds[1]]

    # 11f. verify-parity through the CLI, on the native tokenizer
    example = os.path.join(os.path.dirname(os.path.abspath(__file__)), "datasets",
                           "example_trigenic.tsv")
    with tempfile.TemporaryDirectory() as tmp:
        parses = binding.parses
        reset()
        assert cli_main(["verify-parity", "-f", example, "-k", "3", "-i", "30", "-s", "2",
                         "-n", "10", "-o", tmp, "--device", "cuda"]) == 0
        run_f = counts()
        native_parses = binding.parses - parses
        with open(os.path.join(tmp, "verify_parity.json")) as fh:
            report_f = json.load(fh)

        def python_counts(mode_cfg):
            with open(example, newline="") as fh:
                rows = kuzmin.parse_kuzmin_rows(fh, mode_cfg)
            py = TripletDataset.from_rows(rows, n_ratings=mode_cfg.n_ratings,
                                          arity=kuzmin._arity(mode_cfg))
            return int(py.n_real), int(py.n_genes), int(np.sum(py.ratings == 1))

        fp = report_f["loader_fingerprint"]["modes"]
        for mode, got in fp.items():
            mutant, tau_mode = mode.split("/")
            want = python_counts(DataConfig(mutant_type=mutant, tau_mode=tau_mode))
            assert (got["rows"], got["genes"], got["positives"]) == want, (mode, got, want)
        big = os.path.join(tmp, "big.tsv")
        write_kuzmin_like_tsv(big, n_rows=200_000, n_genes=1000, seed=3)
        t0 = time.perf_counter()
        via_native = load_kuzmin_tsv(big)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        binding.parse_kuzmin_file(big, DataConfig())
        native_parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(big, newline="") as fh:
            rows = kuzmin.parse_kuzmin_rows(fh, DataConfig())
        python_parse_s = time.perf_counter() - t0
        via_python = TripletDataset.from_rows(rows, n_ratings=2)
        python_s = time.perf_counter() - t0
    art = report_f["artifact"]["converged"]
    print(f"[verify-parity] native parses {native_parses}; launches {run_f}; fingerprint "
          f"{json.dumps(fp, sort_keys=True)} (equal to the Python parser's counts); AUC "
          f"{art['auc']}, train L {art['train_loglik_best']}")
    print(f"[tokenizer] {via_native.n_rows} trigenic rows of a 200,000-row file: load and "
          f"pack native {native_s:.4f} s, Python {python_s:.4f} s; the parse to rows alone "
          f"native {native_parse_s:.4f} s, Python {python_parse_s:.4f} s (host CPU "
          f"{_cpu_model()}, not the card)")
    assert native_parses >= 1
    assert run_f.get(em_bdr.KERNEL_NAME, 0) >= 30 and run_f.get(score.KERNEL_NAME, 0) >= 1, run_f
    assert np.isfinite(art["auc"])
    np.testing.assert_array_equal(via_native.triplets, via_python.triplets)
    np.testing.assert_array_equal(via_native.ratings, via_python.ratings)
    launched[em_bdr.KERNEL_NAME] += run_f[em_bdr.KERNEL_NAME]
    launched[score.KERNEL_NAME] += run_f[score.KERNEL_NAME]
    return launched


DIST_TIMEOUT_S = 300   # a rank's process group: a dead peer fails the others
DIST_WAIT_S = 600      # one world of phase 12, start to end
DIST_FIT_RTOL = 1e-5   # a multi-rank fit against the one-process fit (12b, 12c, 12e)
# 12a: a world of one runs the same sums as one process, in the same fixed
# order (no sweep kernel sums floats by atomics), so its final L and its L
# trace are held to equality.
NCCL_ONE_RTOL = 0.0
TP_ATOL = 2e-5         # 12d: the reference's TP fit tolerance (rtol: DIST_FIT_RTOL)
DIST_STEPWISE_RTOL = 1e-4  # 12f: the stepwise fit


def _run_ranks(tag: str, cmd: list, here: str) -> float:
    """Run ``cmd`` (a torchrun launch) from ``here``; echo the ranks'
    ``[12`` lines; fail on a non-zero exit or past DIST_WAIT_S, killing the
    launch's whole process group.  Returns the wall seconds."""
    import signal

    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DIST_WAIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"[{tag}] ranks still running after {DIST_WAIT_S} s")
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        if line.startswith("[12"):
            print(line)
    if proc.returncode != 0:
        print(out[-6000:], file=sys.stderr)
        print(err[-6000:], file=sys.stderr)
        raise AssertionError(f"[{tag}] a rank failed (exit {proc.returncode})")
    return wall


def _torchrun(nproc: int) -> list:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
            "--master-addr", "127.0.0.1", "--master-port", str(port)]


def rank_main(spec: dict) -> int:
    """One rank of a phase-12 fit (``chip_smoke.py --rank SPEC``, started by
    torchrun): ``fit`` over the mesh in ``spec`` on the one card, with the
    kernels' launch counts set to 0 just before and read just after; then
    the per-sweep all_reduce at the fit's shape, timed by CUDA events.
    Writes ``<out>.rank<r>.npz`` and prints one line."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from datetime import timedelta

    from trigenicinteractionpredictor_tpu_torch.config import (
        Config,
        EngineConfig,
        MeshConfig,
        TrainConfig,
    )
    from trigenicinteractionpredictor_tpu_torch.data import TripletDataset
    from trigenicinteractionpredictor_tpu_torch.ops.em import SweepStats
    from trigenicinteractionpredictor_tpu_torch.parallel import sharded_em
    from trigenicinteractionpredictor_tpu_torch.parallel.distributed import (
        maybe_initialize,
        rank_device,
        shutdown,
    )
    from trigenicinteractionpredictor_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
    from trigenicinteractionpredictor_tpu_torch.train.trainer import JsonlLogger, fit
    from trigenicinteractionpredictor_tpu_torch.utils.integrity import check_em_integrity

    topo = maybe_initialize(spec["device"], spec["backend"],
                            timeout=timedelta(seconds=DIST_TIMEOUT_S))
    dev = rank_device(spec["device"])
    rank = topo.process_index
    train = TripletDataset.load_npz(spec["data"])
    ens, model, data = spec["mesh"]
    cfg = Config(train=TrainConfig(**spec["train"]),
                 mesh=MeshConfig(data=data, ensemble=ens, model=model),
                 engine=EngineConfig(backend=spec.get("engine", "auto")))
    counters = _launch_counters()
    events = f"{spec['out']}.events{rank}.jsonl"
    # The sentinel's probes first (a fit runs them on a process's first
    # call), so the counts below are the fit's sweeps alone.
    check_em_integrity(dev, 3)
    with JsonlLogger(events, echo=False) as log:
        for fn in counters.values():
            fn.launches = 0
        res = fit(cfg, train, device=dev, logger=log)
        launches = {name: fn.launches for name, fn in counters.items() if fn.launches}
    with open(events) as fh:
        shard = next(e for e in map(json.loads, fh) if e["event"] == "shard")
    # The per-sweep all_reduce over data at this fit's shape (and, for the
    # tensor-parallel fit, one model all_reduce of a row chunk's A buffer).
    mesh = make_mesh(data=data, ensemble=ens, model=model)
    s_all, G, K = res.states.theta.shape
    S, kb = s_all // ens, K // model
    R = res.states.p.shape[-1]
    stats = SweepStats(torch.zeros(S, G, K, device=dev),
                       torch.zeros(S, K, kb, K, R, device=dev), torch.zeros(S, device=dev))
    reduce_ms = _time_ms(lambda: sharded_em.reduce_stats(stats, mesh), 10)
    extra = ""
    model_ms = None
    if model > 1:
        chunk = min(cfg.engine.jnp_row_chunk, shard["rows"])
        a = torch.zeros(3, S, chunk, K, device=dev)
        model_ms = _time_ms(lambda: sharded_em.all_reduce_packed([a], mesh.group(MODEL_AXIS)),
                            10)
        extra = (f", model all_reduce of one {chunk}-row chunk {model_ms:.4f} ms "
                 f"({-(-shard['rows'] // chunk)} a sweep)")
    # One write a line: the ranks share torchrun's stdout.
    sys.stdout.write(
        f"[{spec['tag']}] rank {rank}/{topo.process_count} on {dev} ({spec['backend']}): "
        f"rows {shard['rows']} from {shard['first_row']}, S_local {shard['samples']}, "
        f"kernel {res.dispatch['kernel']}, launches {json.dumps(launches, sort_keys=True)}, "
        f"{res.sweeps_run} sweeps in {res.wall_seconds:.4f} s, per-sweep data all_reduce "
        f"{reduce_ms:.4f} ms{extra} (CUDA events)\n")
    sys.stdout.flush()
    np.savez(f"{spec['out']}.rank{rank}.npz", final_ll=res.final_loglik, trace=res.ll_trace,
             sweeps=res.sweeps_run, wall=res.wall_seconds, theta=res.states.theta.cpu(),
             p=res.states.p.cpu(), kernel=res.dispatch["kernel"], rows=shard["rows"],
             samples=shard["samples"], launches=json.dumps(launches), reduce_ms=reduce_ms,
             model_ms=-1.0 if model_ms is None else model_ms)
    shutdown()
    return 0


def distributed_phase(card: str, dev, cli_main, train, k1_fit) -> dict:
    """Phase 12 (see the module docstring); ``train`` is phase 6's split and
    ``k1_fit`` phase 6's fit.  Returns the ranks' main-path launches by
    kernel name."""
    import numpy as np

    from trigenicinteractionpredictor_tpu_torch import Config
    from trigenicinteractionpredictor_tpu_torch.data import (
        sample_synthetic_dataset,
        train_test_split,
    )
    from trigenicinteractionpredictor_tpu_torch.ops import em_bdr, em_hybrid, em_large_k
    from trigenicinteractionpredictor_tpu_torch.train.trainer import JsonlLogger, fit

    here = os.path.dirname(os.path.abspath(__file__))
    quiet = JsonlLogger(None, echo=False)
    launched = {em_bdr.KERNEL_NAME: 0, em_hybrid.KERNEL_NAME: 0}
    note = ("ranks share one card: a check of the code across ranks, not of scaling "
            "over GPUs; NCCL above one rank is unchecked here")
    headline = dict(k=HEADLINE["k"], sweeps=50, samples=HEADLINE["samples"],
                    likelihood_freq=10, seed=0)

    def world(tag, nproc, backend, mesh, train_kw, data, engine="auto"):
        out = os.path.join(tmp, tag)
        spec = {"tag": tag, "device": "cuda:0", "backend": backend, "mesh": mesh,
                "train": train_kw, "data": data, "out": out, "engine": engine}
        wall = _run_ranks(tag, _torchrun(nproc) + [os.path.join(here, "chip_smoke.py"),
                                                    "--rank", json.dumps(spec)], here)
        outs = [dict(np.load(f"{out}.rank{r}.npz")) for r in range(nproc)]
        print(f"[{tag}] {nproc} rank(s), {backend}, mesh (ensemble, model, data) = {mesh}: "
              f"command {wall:.2f} s, fit {max(float(o['wall']) for o in outs):.4f} s "
              f"({card}; {note})")
        return outs

    def same_fit(tag, outs, ref, rtol, trace_rtol=None):
        trace_rtol = trace_rtol or rtol
        for o in outs:
            ll_err = float(np.max(np.abs(o["final_ll"] - ref.final_loglik)
                                  / np.abs(ref.final_loglik)))
            tr_err = float(np.max(np.abs(o["trace"] - ref.ll_trace) / np.abs(ref.ll_trace)))
            print(f"[{tag}] against the one-process fit ({ref.sweeps_run} sweeps in "
                  f"{ref.wall_seconds:.4f} s): {int(o['sweeps'])} sweeps, final L max rel err "
                  f"{ll_err:.3e} (rtol {rtol:g}), trace {tr_err:.3e} (rtol {trace_rtol:g})")
            assert int(o["sweeps"]) == ref.sweeps_run
            assert np.isfinite(o["final_ll"]).all() and ll_err <= rtol
            assert tr_err <= trace_rtol

    def k1_launches(outs, sweeps):
        for o in outs:
            n = json.loads(str(o["launches"])).get(em_bdr.KERNEL_NAME, 0)
            assert str(o["kernel"]) == em_bdr.KERNEL_NAME and n >= sweeps, (o["kernel"], n)
            launched[em_bdr.KERNEL_NAME] += n

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "train.npz")
        train.save_npz(data)
        n_train = train.n_rows

        # 12a. a world of one under NCCL: the mesh code with its collectives
        outs = world("12a", 1, "nccl", (1, 1, 1), headline, data)
        k1_launches(outs, 50)
        same_fit("12a", outs, k1_fit, NCCL_ONE_RTOL)

        # 12b. two gloo ranks, data 2
        outs = world("12b", 2, "gloo", (1, 1, 2), headline, data)
        k1_launches(outs, 50)
        assert [int(o["rows"]) for o in outs] == [-(-n_train // 2), n_train - (-(-n_train // 2))]
        same_fit("12b", outs, k1_fit, DIST_FIT_RTOL)

        # 12c. four gloo ranks, data 2 x ensemble 2: K1 at S_local = 5
        outs = world("12c", 4, "gloo", (2, 1, 2), headline, data)
        k1_launches(outs, 50)
        assert all(int(o["samples"]) == HEADLINE["samples"] // 2 for o in outs)
        same_fit("12c", outs, k1_fit, DIST_FIT_RTOL)

        # 12d. tensor parallelism, model 2, K = 50, against the one-process K3 fit
        tp_kw = dict(k=50, sweeps=10, samples=2, likelihood_freq=5, seed=0)
        outs = world("12d", 2, "gloo", (1, 2, 1), tp_kw, data)
        ref_cfg = Config()
        ref_cfg = ref_cfg.replace(train=dataclasses.replace(ref_cfg.train, **tp_kw))
        ref = fit(ref_cfg, train, device=dev, logger=quiet)
        assert ref.dispatch["kernel"] == em_large_k.KERNEL_NAME, ref.dispatch
        same_fit("12d", outs, ref, DIST_FIT_RTOL)
        for o in outs:
            th = float(np.abs(o["theta"] - ref.states.theta.cpu().numpy()).max())
            pp = float(np.abs(o["p"] - ref.states.p.cpu().numpy()).max())
            print(f"[12d] kernel {o['kernel']}; theta max abs err {th:.3e}, p {pp:.3e} "
                  f"(atol {TP_ATOL:g})")
            assert str(o["kernel"]) == "jnp-tp" and th <= TP_ATOL and pp <= TP_ATOL

        # 12e. the K-sweep job's units over two ranks, through the CLI
        synth = os.path.join(tmp, "synth.npz")
        assert cli_main(["synth", "-o", synth, "-n", str(HEADLINE["n"]),
                         "-g", str(HEADLINE["genes"]), "-k", str(HEADLINE["k"]),
                         "--seed", "0"]) == 0
        grid = ["--k-grid", "5,10", "-s", str(HEADLINE["samples"]), "-i", "10", "-n", "5"]
        ranks_dir, one_dir = os.path.join(tmp, "sweep2"), os.path.join(tmp, "sweep1")
        wall = _run_ranks("12e", _torchrun(2) + [
            "-m", "trigenicinteractionpredictor_tpu_torch", "sweep", "-f", synth, *grid,
            "-o", ranks_dir, "--device", "cuda:0", "--dist-backend", "gloo",
            "--dist-timeout", str(DIST_TIMEOUT_S)], here)
        assert cli_main(["sweep", "-f", synth, *grid, "-o", one_dir, "--device", "cuda"]) == 0
        with open(os.path.join(ranks_dir, "report.json")) as fh:
            got = json.load(fh)
        with open(os.path.join(one_dir, "report.json")) as fh:
            want = json.load(fh)
        starts = {}
        for r in (0, 1):
            with open(os.path.join(ranks_dir, f"events_p{r}.jsonl")) as fh:
                starts[r] = [e["unit"] for e in map(json.loads, fh) if e["event"] == "unit_start"]
        print(f"[12e] sweep --k-grid 5,10 on 2 ranks: units by rank {starts}, command "
              f"{wall:.2f} s ({card}; {note})")
        assert [len(u) for u in starts.values()] == [1, 1]
        assert [u["unit"] for u in got["units"]] == [u["unit"] for u in want["units"]]
        for g, w in zip(got["units"], want["units"]):
            err = float(np.max(np.abs(np.subtract(g["ll_per_sample"], w["ll_per_sample"]))
                               / np.abs(w["ll_per_sample"])))
            print(f"[12e] {g['unit']} (rank {g['process']}, {g['dispatch']['kernel']}): final L "
                  f"max rel err against one process {err:.3e}, heldout L {g['heldout_loglik']:.6g}"
                  f" / {w['heldout_loglik']:.6g} (rtol {DIST_FIT_RTOL:g})")
            assert g["sweeps"] == w["sweeps"] and err <= DIST_FIT_RTOL
            assert abs(g["heldout_loglik"] - w["heldout_loglik"]) <= DIST_FIT_RTOL * abs(
                w["heldout_loglik"])
        assert got["summary"]["best_k_per_fold"] == want["summary"]["best_k_per_fold"]

        # 12f. phase 9b's stepwise fit over two ranks (data 2, route K7)
        G, K = 6000, 25
        big, _, _ = sample_synthetic_dataset(STEPWISE_N, G, K, n_ratings=2, seed=0)
        big_train, _ = train_test_split(big, 0.2, seed=0)
        big_data = os.path.join(tmp, "big.npz")
        big_train.save_npz(big_data)
        sw_kw = dict(k=K, sweeps=3, samples=2, likelihood_freq=1, seed=0,
                     minibatch=STEPWISE_MB, stream_groups=4)
        outs = world("12f", 2, "gloo", (1, 1, 2), sw_kw, big_data)
        sw_cfg = Config()
        sw_cfg = sw_cfg.replace(train=dataclasses.replace(sw_cfg.train, **sw_kw))
        ref = fit(sw_cfg, big_train, device=dev, logger=quiet)
        assert ref.dispatch["kernel"] == em_hybrid.KERNEL_NAME, ref.dispatch
        same_fit("12f", outs, ref, DIST_STEPWISE_RTOL)
        for o in outs:
            n = json.loads(str(o["launches"])).get(em_hybrid.KERNEL_NAME, 0)
            assert str(o["kernel"]) == em_hybrid.KERNEL_NAME and n >= 3, (o["kernel"], n)
            launched[em_hybrid.KERNEL_NAME] += n
    return launched


# Phase 13: the records of tests/perf_records.json that 13c runs, and the
# route each S must take there (ops/dispatch.py::route at that shape).
BENCH_RECORDS = {
    "large_k50_s10": ("cuda-em-sweep-large-k", "cuda-em-sweep-large-k"),
    "large_g100k_s10": ("cuda-em-large-g", "cuda-em-bdg"),
    "wide_s50_k10": ("cuda-em-sweep", "cuda-em-sweep"),
    "bd_plan_wide_s50_g10k": ("cuda-em-sweep", "cuda-em-bdg"),
}
BENCH_HEADLINE_LAUNCHES = 2 * (10 + 3 * 120)  # S = 1 and S = 10: first step + 3 reps


def _check_engine_step(tag: str, ds, states0, route: str, n_inner: int = 10) -> None:
    """One chained step of the bench (``n_inner`` sweeps from ``states0``)
    through the routed stats function and through the plain one, each on
    its own fit batch of ``ds``'s rows: theta and p held to STATS_REL_TOL
    (max abs err / max |plain|), every L of the step to LOGLIK_RTOL."""
    import torch

    from trigenicinteractionpredictor_tpu_torch.bench import make_engine_step
    from trigenicinteractionpredictor_tpu_torch.ops import dispatch

    dev = states0.theta.device
    s, g, k = states0.theta.shape
    routed = dispatch.resolve_stats_fn(dev, 3, g, k, s, n_rows=ds.n_rows)
    assert routed.kernel_name == route, (tag, s, routed.kernel_name, route)
    # Row chunks bound the plain sweep's [S, rows, K^2 R] intermediates.
    chunk = 4096 if k > 20 else max(4096, 1_310_720 // s)
    plain = dispatch.stats_fn_for(dispatch.PLAIN_NAME, k, 2, row_chunk=chunk)
    got, ll = make_engine_step(ds, routed, dev, n_inner)(states0)
    want, ll_want = make_engine_step(ds, plain, dev, n_inner)(states0)
    errs = {}
    for name, a, b in (("theta", got.theta, want.theta), ("p", got.p, want.p)):
        errs[name] = float((a - b).abs().max()) / float(b.abs().max())
        assert torch.isfinite(a).all() and errs[name] <= STATS_REL_TOL, (tag, s, name, errs)
    ll_rel = float(((ll - ll_want).abs() / ll_want.abs()).max())
    print(f"[{tag}] S={s} route {route}: one step ({n_inner} sweeps) vs plain: theta "
          f"{errs['theta']:.3e}, p {errs['p']:.3e} max abs err / max|plain| (tol "
          f"{STATS_REL_TOL:g}); L max rel err {ll_rel:.3e} (tol {LOGLIK_RTOL:g})")
    assert torch.isfinite(ll).all() and ll_rel <= LOGLIK_RTOL, (tag, s, ll_rel)
    del got, want, ll, ll_want
    torch.cuda.empty_cache()


def _check_bench_steps(tag: str, args, routes) -> None:
    """:func:`_check_engine_step` at each S ``bench.measure_engine`` ran
    (1, then ``args.samples``), from its rows and initial states."""
    import torch

    from trigenicinteractionpredictor_tpu_torch import bench
    from trigenicinteractionpredictor_tpu_torch.data.synthetic import sample_synthetic_dataset
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state

    dev = torch.device("cuda")
    ds, _, _ = sample_synthetic_dataset(args.n, args.genes, args.k, n_ratings=bench.R, seed=0)
    for s, route in zip((1, args.samples), routes):
        _check_engine_step(tag, ds, init_state(args.genes, args.k, bench.R, samples=s,
                                               seed=0, device=dev), route)


def bench_phase(card: str, here: str, cli_main, fit_sweeps_per_s: float) -> dict:
    """Phase 13 (see the module docstring); returns the phase's main-path
    launches by kernel name."""
    import contextlib
    import io
    import re

    import torch

    from trigenicinteractionpredictor_tpu_torch import bench, bench_quality
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu_torch.models.threefry import reference_init_states
    from trigenicinteractionpredictor_tpu_torch.ops import em_bdr, score

    t_phase = time.perf_counter()
    counters = _launch_counters()

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counters.items()}

    with open(os.path.join(here, "tests", "perf_records.json")) as fh:
        records = json.load(fh)
    total = dict.fromkeys(counters, 0)

    # 13a. the headline bench through the CLI, in process
    zero()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert cli_main(["bench"]) == 0
    wall = time.perf_counter() - t0
    grew = read()
    for line in err.getvalue().splitlines():
        print(f"[13a] {line}")
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"[13a] {json.dumps(line)} ({card}; command {wall:.2f} s)")
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}, line
    assert line["metric"] == "em_restart_triplet_updates_per_sec_per_chip", line
    assert line["unit"] == "triplets/s" and line["vs_baseline"] >= 100, line
    routes = dict(re.findall(r"^S=(\d+) route (\S+): first step", err.getvalue(), re.M))
    assert routes == {"1": em_bdr.KERNEL_NAME, "10": em_bdr.KERNEL_NAME}, routes
    assert grew[em_bdr.KERNEL_NAME] == grew[BLOCK_SUM] == BENCH_HEADLINE_LAUNCHES, grew
    assert sum(grew.values()) == 2 * BENCH_HEADLINE_LAUNCHES, grew
    s1 = float(re.search(r"^S=1 route .* -> (\S+) restart-triplet", err.getvalue(), re.M)[1])
    print(f"[13a] S=10: {line['value']:.6e} restart-triplet updates/s, "
          f"{line['value'] / (131_072 * 10):.2f} sweeps/s (phase 6's fit "
          f"{fit_sweeps_per_s:.2f} sweeps/s); S=1: {s1:.6e} updates/s, "
          f"{s1 / 131_072:.2f} sweeps/s; K1 launches {grew[em_bdr.KERNEL_NAME]} ({card})")
    total = {k: total[k] + grew[k] for k in total}
    _check_bench_steps("13a", bench.parse_args([]), (em_bdr.KERNEL_NAME,) * 2)

    # 13b. --serve at the headline shape: the timed scorer against the plain one
    zero()
    run = bench.measure_serving(bench.parse_args(["--serve"]))
    grew = read()
    want = score.ensemble_score_reference(run.states.theta, run.states.p, run.triplets)
    err_abs = float((run.scores - want).abs().max())
    print(f"[13b] route {run.route}: {run.ms:.4f} ms a call, {run.rows_per_sec:.6e} rows/s "
          f"(131072 rows, S=10); launches {grew[score.KERNEL_NAME]}; timed scorer vs plain "
          f"max abs err {err_abs:.3e} (tol {SCORE_ATOL:g}) ({card})")
    assert run.route == score.KERNEL_NAME, run.route
    assert grew[score.KERNEL_NAME] == 1 + 3 * 20 and sum(grew.values()) == 1 + 3 * 20, grew
    assert torch.isfinite(run.scores).all() and err_abs <= SCORE_ATOL
    total = {k: total[k] + grew[k] for k in total}
    del run, want

    # 13c. the engine at the other throughput records' args (no baseline)
    for name, want_routes in BENCH_RECORDS.items():
        rec = records["records"][name]
        zero()
        args = bench.parse_args(rec["args"] + ["--device", "cuda"])
        runs = bench.measure_engine(args)
        grew = read()
        for r, want_route in zip(runs, want_routes):
            print(f"[13c] {name} (n={rec['n']}, g={rec['g']}, k={rec['k']}) S={r.samples}: "
                  f"route {r.route}, {r.updates_per_sec:.6e} restart-triplet updates/s, "
                  f"{r.sweeps} sweeps in {r.seconds:.6f} s (best of 3), launches "
                  f"{r.launches} ({card})")
            assert r.route == want_route and r.launches, (name, r.samples, r.route)
        assert sum(grew.values()) == sum(sum(r.launches.values()) for r in runs), grew
        total = {k: total[k] + grew[k] for k in total}
        del runs
        torch.cuda.empty_cache()
        _check_bench_steps(f"13c {name}", args, want_routes)

    # 13d. time to converged AUC at both quality records, held to their bands
    for name in ("default", "recoverable"):
        rec = records["quality"][name]
        args = bench_quality.parse_args(rec["args"] + ["--device", "cuda"])
        sweeps = args.max_sweeps // args.freq * args.freq
        zero()
        res = bench_quality.measure(args)
        grew = read()
        print(f"[13d] {name}: {json.dumps(res)}; launches "
              f"{ {k: v for k, v in grew.items() if v} } ({card})")
        print(f"[13d] {name}: auc_final {res['auc_final']:.6f} (record {rec['auc_final']} "
              f"+- {rec['auc_band']}), sweeps_to_converged {res['sweeps_to_converged']} "
              f"(record {rec['sweeps_to_converged']} + slack {rec['sweeps_slack']}), "
              f"auc_bayes {res['auc_bayes']:.6f}; seconds_per_sweep "
              f"{res['seconds_per_sweep']:.6e}, seconds_to_converged_auc {res['value']:.6f} "
              f"({card})")
        assert abs(res["auc_final"] - rec["auc_final"]) <= rec["auc_band"], (name, res)
        assert res["sweeps_to_converged"] <= rec["sweeps_to_converged"] + rec["sweeps_slack"]
        if "auc_chance_floor" in rec:
            assert res["auc_final"] >= rec["auc_chance_floor"], (name, res)
        # K1: the untimed first step and the timed loop; K2: the first step's
        # check, the Bayes ceiling and one check a step.
        assert grew[em_bdr.KERNEL_NAME] == args.freq + sweeps, grew
        assert grew[score.KERNEL_NAME] == 2 + sweeps // args.freq, grew
        assert grew[BLOCK_SUM] == grew[em_bdr.KERNEL_NAME], grew
        assert sum(grew.values()) == (grew[em_bdr.KERNEL_NAME] + grew[BLOCK_SUM]
                                      + grew[score.KERNEL_NAME]), grew
        total = {k: total[k] + grew[k] for k in total}
        # The first step bench_quality took, against the plain sweep; then
        # the run from the numpy draw fit starts from (seed 0), held to the
        # AUC band and chance floor only: the records' sweeps came from the
        # reference's draw, which bench_quality starts from.
        case = bench_quality.quality_case(args)
        _check_engine_step(f"13d {name}", case.train, reference_init_states(
            args.seed, args.samples, args.genes, args.k, bench_quality.R, device=case.dev),
            case.route, args.freq)
        own = bench_quality.train_to_converged(
            case.step, init_state(args.genes, args.k, bench_quality.R, samples=args.samples,
                                  seed=0, device=case.dev),
            case.check_auc, args.max_sweeps, args.freq, args.tol)
        print(f"[13d] {name}, fit's numpy draw (seed 0): auc_final {own.auc_final:.6f} "
              f"(record {rec['auc_final']} +- {rec['auc_band']}), sweeps_to_converged "
              f"{own.sweeps_to_converged} (held to nothing), seconds_per_sweep "
              f"{own.seconds_per_sweep:.6e}, seconds_to_converged_auc "
              f"{own.seconds_to_converged:.6f} ({card})")
        assert abs(own.auc_final - rec["auc_final"]) <= rec["auc_band"], (name, own.auc_final)
        assert own.auc_final >= rec.get("auc_chance_floor", 0.0), (name, own.auc_final)
        del case, own
    print(f"[13] phase wall {time.perf_counter() - t_phase:.2f} s; launches "
          f"{ {k: v for k, v in total.items() if v} }")
    return total


def _four_knob_fit():
    """Phase 11e's rows (G = 200, N = 4096) and config (S = 4, annealing,
    spectral init, two split-merge and two refine rounds)."""
    from trigenicinteractionpredictor_tpu_torch import Config
    from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset

    K, R = HEADLINE["k"], HEADLINE["ratings"]
    small, _, _ = sample_synthetic_dataset(4096, 200, K, n_ratings=R, seed=4)
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, k=K, sweeps=20, samples=4, likelihood_freq=5, seed=5, anneal_beta0=ANNEAL_BETA,
        anneal_sweeps=10, init_method="spectral", smem_rounds=2, smem_sweeps=5, refine_rounds=2,
        refine_sweeps=5))
    return small, cfg


class _Events:
    """A fit logger that keeps its events."""

    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


# Phase 14: each sweep route at the shapes of phases 3-10, (route, K, G, S);
# K1 at G = 100,000 takes its streams form (ops/em_bdr.py::theta_in_part).
SAME_BITS_ROUTES = (
    ("cuda-em-sweep", 10, 1000, 10),
    ("cuda-em-sweep", 10, 100_000, 10),
    ("cuda-em-sweep-large-k", 50, 1000, 10),
    ("cuda-em-sweep-large-k", 72, 1000, 10),
    ("cuda-em-hybrid", 25, 6000, 2),
    ("cuda-em-bdg", 10, 100_000, 10),
    ("cuda-em-bd-plan", 10, 500_000, 10),
    ("cuda-em-large-g", 10, 100_000, 1),
    ("cuda-em-rsorted", 10, 1000, 10),
    ("torch", 10, 1000, 10),
)


def determinism_phase(card: str, dev, train, k1_fit) -> None:
    """Phase 14 (see the module docstring): every sweep route, K9 and the
    plain sweep on CUDA run twice at the shapes of phases 3-10 give the same
    bits; phase 6's fit run again gives the same final states and L trace;
    phase 11e's four-knob fit run twice on the kernel route patches the
    same lanes with the same bits."""
    import numpy as np
    import torch

    from trigenicinteractionpredictor_tpu_torch import Config
    from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu_torch.ops import dispatch, em_bdr, em_rsorted
    from trigenicinteractionpredictor_tpu_torch.train.trainer import (
        JsonlLogger,
        _make_fit_batch,
        fit,
    )

    t_phase = time.perf_counter()
    N, R = HEADLINE["n"], HEADLINE["ratings"]
    quiet = JsonlLogger(None, echo=False)
    counters = _launch_counters()
    for name, k, g, s in SAME_BITS_ROUTES:
        if name == em_rsorted.KERNEL_NAME:
            stats_fn = em_rsorted.stats_fn(RSORT_TILE)
        else:
            stats_fn = dispatch.stats_fn_for(name, k, R, row_chunk=16_384)
        ds, _, _ = sample_synthetic_dataset(N, g, 10, n_ratings=R, seed=7)
        batch = _make_fit_batch(ds, stats_fn, dev, quiet)
        st = init_state(g, k, R, samples=s, seed=8, device=dev)
        before = {n: fn.launches for n, fn in counters.items()}
        runs = [stats_fn(st.theta, st.p, batch) for _ in range(2)]
        torch.cuda.synchronize()
        ran = {n: fn.launches - before[n] for n, fn in counters.items() if fn.launches > before[n]}
        for field in ("theta_hat", "p_hat", "loglik"):
            a, b = getattr(runs[0], field), getattr(runs[1], field)
            assert torch.isfinite(a).all() and torch.equal(a, b), (name, k, g, s, field)
        if name == em_bdr.KERNEL_NAME:
            streams = not em_bdr.theta_in_part(N, s, g, k, em_bdr.sweep_plan(k, R)[0],
                                                em_bdr.sm_count(dev))
            assert streams == (g == 100_000), (g, streams)
            assert ("cuda-plan-scatter" in ran) == streams, ran
        kernels = [] if name == dispatch.PLAIN_NAME else [
            fn.kernel_name for fn in dispatch.route_kernels(name)
        ] if name != em_rsorted.KERNEL_NAME else [em_rsorted.KERNEL_NAME, BLOCK_SUM]
        assert all(ran.get(kn) == 2 for kn in kernels), (name, ran)
        print(f"[14 same bits] {name} K={k} G={g} S={s} (N={N}): theta_hat, p_hat, loglik "
              f"equal over two runs (torch.equal); launches {ran}")
        del runs, batch, st, ds
        torch.cuda.empty_cache()

    # Phase 6's fit again (no checkpoints: they change no arithmetic).
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, k=HEADLINE["k"], sweeps=50, samples=HEADLINE["samples"], likelihood_freq=10,
        seed=0))
    again = fit(cfg, train, device=dev, logger=quiet)
    assert torch.equal(again.states.theta, k1_fit.states.theta)
    assert torch.equal(again.states.p, k1_fit.states.p)
    assert np.array_equal(again.ll_trace, k1_fit.ll_trace)
    assert np.array_equal(again.final_loglik, k1_fit.final_loglik)
    print(f"[14 same bits] phase 6's fit run again: final states, L trace "
          f"({again.ll_trace.shape[0]} checks) and final L identical")

    # Phase 11e's four-knob fit twice on the kernel route.
    small, cfg = _four_knob_fit()
    fits = []
    for _ in range(2):
        ev = _Events()
        res = fit(cfg, small, device=dev, logger=ev)
        rounds = [(e, f.get("from_ll"), f.get("to_ll"), f.get("accepted_move"))
                  for e, f in ev.events if e in ("smem_done", "refine_done")]
        fits.append((res, rounds))
    (a, ra), (b, rb) = fits
    assert a.dispatch["kernel"] == em_bdr.KERNEL_NAME
    assert ra == rb, (ra, rb)
    assert np.array_equal(a.final_loglik, b.final_loglik), (a.final_loglik, b.final_loglik)
    assert torch.equal(a.states.theta, b.states.theta) and torch.equal(a.states.p, b.states.p)
    print(f"[14 same bits] phase 11e's four-knob fit twice: final L {a.final_loglik.tolist()} "
          f"lane for lane, every round {ra} and the final states identical")
    print(f"[14] phase wall {time.perf_counter() - t_phase:.2f} s ({card})")


def studies_phase(card: str) -> None:
    """Phase 15: each ported study of ``tools/`` at a small size on the card,
    in process (its JSON lines checked for their keys)."""
    import contextlib
    import io

    from trigenicinteractionpredictor_tpu_torch.tools import (
        quality_study,
        split_merge_study,
        stepwise_host_cost,
        tensor_spectral_study,
    )

    small = ["-n", "20000", "-g", "200", "-k", "10"]
    runs = (
        ("stepwise_host_cost", stepwise_host_cost,
         ["--n", "1000000", "--mb", "131072", "--workers", "4"], "pipeline"),
        ("quality_study", quality_study, ["--small", "-i", "60", "-s", "4"], "arm"),
        ("split_merge_study", split_merge_study,
         ["--small", "-i", "60", "-s", "4", "--rounds", "2", "--cands", "4", "--resweep", "20"],
         "arm"),
        ("tensor_spectral_study", tensor_spectral_study, small + ["--seeds", "1", "--sweeps", "60"],
         "method"),
    )
    for name, mod, argv, key in runs:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            assert mod.main(argv + ["--device", "cuda"]) == 0, name
        lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
        assert any(key in ln for ln in lines), (name, lines)
        for ln in lines:
            print(f"[15 {name}] {json.dumps(ln)}")
        print(f"[15 {name}] {time.perf_counter() - t0:.2f} s ({card})")


def _device_ms(fn, reps: int) -> float:
    """Device ms per call of everything ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
             for ev in prof.key_averages())
    assert us > 0, "the profiler saw no device time"
    return us / 1e3 / reps


def _time_block_sum(card: str, dev) -> dict:
    """The block sum's row of the kernels line, at K1's partials at the
    headline shape (S = 10, the blocks of em_bdr.launch_plan, [G K | K^3 R
    | 1] a block)."""
    import torch

    from trigenicinteractionpredictor_tpu_torch.ops import block_sum, em_bdr

    N, G, K, R, S = (HEADLINE[k] for k in ("n", "genes", "k", "ratings", "samples"))
    tile = em_bdr.sweep_plan(K, R)[0]
    _, nb = em_bdr.launch_plan(N, S, tile, em_bdr.sm_count(dev))
    cells = K ** 3 * R
    ld = G * K + cells + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    part = torch.rand((S, nb, ld), device=dev, generator=gen)
    segs = [block_sum.Segment(part, 0, G * K), block_sum.Segment(part, G * K, cells),
            block_sum.Segment(part, G * K + cells, 1)]
    got = block_sum.block_sum(segs)
    want = block_sum.block_sum_reference(segs)
    again = block_sum.block_sum(segs)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, again)) and err <= 1e-4 * nb
    # Device time from the profiler: a call's host side (three output
    # tensors, the ctypes call) outlasts the kernel's few microseconds.
    ms = _device_ms(lambda: block_sum.block_sum(segs), 50)
    plain = _device_ms(lambda: block_sum.block_sum_reference(segs), 50)
    library = _device_ms(lambda: part.sum(1), 50)
    bound = _bound(float(S * nb * ld), 4.0 * S * nb * ld + 4.0 * S * ld)
    print(f"[block_sum] S={S}, {nb} blocks x {ld} floats: {ms:.4f} ms, plain {plain:.4f} ms, "
          f"one torch.sum {library:.4f} ms of device time a call (torch.profiler), bound "
          f"{bound[0]:.4f} ms ({bound[1]}); max abs err {err:.3e}; same bits twice ({card})")
    return {"name": "block_sum", "route": "cuda",
            "source": "trigenicinteractionpredictor_tpu_torch/csrc/block_sum.cu",
            "replaces": "trigenicinteractionpredictor_tpu/ops/pallas_em_bdr.py:265",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one GPU",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np

    import trigenicinteractionpredictor_tpu_torch as port
    from trigenicinteractionpredictor_tpu_torch import Config
    from trigenicinteractionpredictor_tpu_torch.data import (
        TripletDataset,
        sample_synthetic_dataset,
        train_test_split,
    )
    from trigenicinteractionpredictor_tpu_torch.device import resolve_device
    from trigenicinteractionpredictor_tpu_torch.eval import evaluate
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu_torch.cli import main as cli_main
    from trigenicinteractionpredictor_tpu_torch.ab_kernels import pass_split
    from trigenicinteractionpredictor_tpu_torch.ops import (
        _build,
        block_sum,
        em_bd,
        em_bdg,
        em_bdr,
        em_hybrid,
        em_large_k,
        score,
    )
    from trigenicinteractionpredictor_tpu_torch.ops.dispatch import plain_stats
    from trigenicinteractionpredictor_tpu_torch.ops.em import make_batch
    from trigenicinteractionpredictor_tpu_torch.ops.scoring import (
        serve_predict_interaction,
    )
    from trigenicinteractionpredictor_tpu_torch.train.checkpoint import load_checkpoint
    from trigenicinteractionpredictor_tpu_torch.train.trainer import JsonlLogger, fit

    if not os.path.abspath(port.__file__).startswith(os.path.join(here, "")):
        print(f"chip_smoke: imported the port from {port.__file__}, not from this "
              f"checkout ({here})", file=sys.stderr)
        return 1

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = resolve_device("cuda")
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_info.get('seconds', 0.0):.2f} s)")
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")

    # 2b. the integrity sentinel
    sentinel_phase(card, dev)

    # 3. K1 against its plain version at the headline shape
    N, G, K, R, S = (HEADLINE[k] for k in ("n", "genes", "k", "ratings", "samples"))
    # The generator's alpha is the reference's quality-bench default
    # (bench_quality.py --alpha 0.2): at this shape EM plateaus a little
    # above chance (ensemble AUC ~0.51 there), which the AUC check needs.
    ds, _, _ = sample_synthetic_dataset(
        N, G, K, n_ratings=R, alpha_theta=0.2, alpha_p=0.2, seed=0
    )
    init = init_state(G, K, R, samples=S, seed=1, device=dev)
    batch = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
    ref = em_bdr.em_ensemble_stats_reference(init.theta, init.p, batch)
    out = em_bdr.em_ensemble_stats(init.theta, init.p, batch)
    f64 = em_bdr.em_ensemble_stats_reference(init.theta.double(), init.p.double(), batch)
    torch.cuda.synchronize()
    k1_err = _check_stats("K1", out, ref, f64)
    del f64
    k1_ms = _time_ms(lambda: em_bdr.em_ensemble_stats(init.theta, init.p, batch), 20)
    k1_plain_ms = _time_ms(
        lambda: em_bdr.em_ensemble_stats_reference(init.theta, init.p, batch), 5
    )
    k1_bound = _bound(_sweep_flops(N, K, S), _sweep_bytes(N, G, K, R, S))
    print(f"[K1] {k1_ms:.4f} ms/sweep-stats, plain {k1_plain_ms:.4f} ms, bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}) (N={N}, G={G}, K={K}, R={R}, S={S}; {card})")
    del ref, out

    # 4. K3 against its plain version at the headline N, G, R, S.  The plain
    # float32 version is row-chunked (16,384 rows, the reference's default);
    # the float64 one at 4,096 rows keeps its intermediates near 3 GB.
    k3_err, k3_times = 0.0, {}
    for k in K3_GRID:
        st = init_state(G, k, R, samples=S, seed=1, device=dev)
        out = em_large_k.em_ensemble_stats(st.theta, st.p, batch)
        ref = em_large_k.em_ensemble_stats_reference(st.theta, st.p, batch)
        f64 = em_large_k.em_ensemble_stats_reference(
            st.theta.double(), st.p.double(), batch, row_chunk=4096
        )
        torch.cuda.synchronize()
        k3_err = max(k3_err, _check_stats(f"K3 K={k}", out, ref, f64))
        del out, ref, f64
        ms = _time_ms(lambda: em_large_k.em_ensemble_stats(st.theta, st.p, batch), 5)
        plain = _time_ms(
            lambda: em_large_k.em_ensemble_stats_reference(st.theta, st.p, batch), 3
        )
        bound = _bound(_sweep_flops(N, k, S), _sweep_bytes(N, G, k, R, S))
        split = {}
        if k in (50, em_large_k.MAX_K):
            split = pass_split(lambda: em_large_k.em_ensemble_stats(st.theta, st.p, batch), 2)
        k3_times[k] = (ms, plain, bound, split)
        print(f"[K3] K={k}: {ms:.4f} ms/sweep-stats, plain {plain:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}) (N={N}, G={G}, R={R}, S={S}; {card})")
        if split:
            print(f"[K3] K={k}: pass 1 {split['pass1']:.4f} ms, pass 2 {split['pass2']:.4f} ms, "
                  f"the rest of the call (pack, rating order) {split['other']:.4f} ms of "
                  f"device time per call (torch.profiler; {card})")
        del st
    # K3 at K8's shape: where the reference runs its grouped bdrg kernel
    k8, g8 = K8_SHAPE
    ds8, _, _ = sample_synthetic_dataset(N, g8, K, n_ratings=R, seed=2)
    batch8 = make_batch(ds8.triplets, ds8.ratings, ds8.weights, dev)
    st = init_state(g8, k8, R, samples=S, seed=1, device=dev)
    out = em_large_k.em_ensemble_stats(st.theta, st.p, batch8)
    ref = em_large_k.em_ensemble_stats_reference(st.theta, st.p, batch8)
    f64 = em_large_k.em_ensemble_stats_reference(
        st.theta.double(), st.p.double(), batch8, row_chunk=4096
    )
    torch.cuda.synchronize()
    k3_err = max(k3_err, _check_stats(f"K3 K={k8}, G={g8}", out, ref, f64))
    del out, ref, f64
    k8_ms = _time_ms(lambda: em_large_k.em_ensemble_stats(st.theta, st.p, batch8), 5)
    k8_plain = _time_ms(
        lambda: em_large_k.em_ensemble_stats_reference(st.theta, st.p, batch8), 3
    )
    k8_bound = _bound(_sweep_flops(N, k8, S), _sweep_bytes(N, g8, k8, R, S))
    print(f"[K3] K={k8}, G={g8} (K8's shape): {k8_ms:.4f} ms/sweep-stats, plain "
          f"{k8_plain:.4f} ms, bound {k8_bound[0]:.4f} ms ({k8_bound[1]}) (N={N}, R={R}, "
          f"S={S}; {card})")
    del st, batch8, ds8
    torch.cuda.empty_cache()

    # 5. K2 against its plain version.  At G = 1000 (K = 10 and K = 50) also
    # the yardstick, one einsum over the gathered rows giving D[b,s,r] (th3
    # with p first, so no [S,B,K,K,K] intermediate forms), and two bounds:
    # K2's own, for the interaction rating's slice of p alone (per row and
    # restart sum_m th3 p is K^3 multiply-adds, then K^2 over l and K over k;
    # bytes: theta, the slice, ids, out), and the bound of all R ratings,
    # which is what the einsum and the plain scorer compute.
    k2_err, k2 = 0.0, {}
    for g, n, k in ((G, N, K), (G, 32_768, 50), (100_000, 16_384, K)):
        dsg, _, _ = sample_synthetic_dataset(n, g, K, n_ratings=R, seed=2)
        st = (init if (g, k) == (G, K)
              else init_state(g, k, R, samples=S, seed=3, device=dev))
        trips = torch.as_tensor(dsg.triplets, dtype=torch.int32, device=dev)
        want = score.ensemble_score_reference(st.theta, st.p, trips)
        got = score.ensemble_score(st.theta, st.p, trips)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"[K2] G={g}, K={k}, rows={n}: max abs err {err:.3e} (tol {SCORE_ATOL:g})")
        assert torch.isfinite(got).all() and err <= SCORE_ATOL
        k2_err = max(k2_err, err)
        ms = _time_ms(lambda: score.ensemble_score(st.theta, st.p, trips), 20)
        plain = _time_ms(lambda: score.ensemble_score_reference(st.theta, st.p, trips), 5)
        print(f"[K2] G={g}, K={k}, rows={n}: {ms:.4f} ms, plain {plain:.4f} ms ({card})")
        if g == G:
            rows = [st.theta[:, trips[:, q].long(), :] for q in range(3)]
            library = _time_ms(lambda: torch.einsum(
                "sbm,sklmr,sbl,sbk->bsr", rows[2], st.p, rows[1], rows[0]), 5)
            flops = 2.0 * n * S * (k**3 + k**2 + k)
            ids_out = 12.0 * n + 4.0 * n
            own = _bound(flops, 4.0 * S * g * k + 4.0 * S * k**3 + ids_out)
            all_r = _bound(R * flops, 4.0 * S * g * k + 4.0 * S * k**3 * R + ids_out)
            k2[k] = {"ms": ms, "plain_ms": plain, "library_ms": library,
                     "bound_ms": own[0], "bound_by": own[1], "bound_all_ratings_ms": all_r[0]}
            print(f"[K2] G={g}, K={k}, rows={n}: einsum (all {R} ratings) {library:.4f} ms; "
                  f"K2's own bound (one rating's slice) {own[0]:.4f} ms ({own[1]}), bound "
                  f"of all {R} ratings {all_r[0]:.4f} ms ({all_r[1]}) ({card})")
            del rows

    # 6. the fit path, through the entry points a user calls
    train, test = train_test_split(ds, 0.2, seed=0)
    sweeps = 50
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(out_dir=tmp)
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, k=K, sweeps=sweeps, samples=S, likelihood_freq=10,
            checkpoint_every=25, seed=0,
        ))
        ckpt = os.path.join(tmp, "model.ckpt.npz")
        with JsonlLogger(os.path.join(tmp, "events.jsonl"), echo=False) as logger:
            em_bdr.em_ensemble_stats.launches = 0
            score.ensemble_score.launches = 0
            block_sum.block_sum.launches = 0
            res = fit(cfg, train, device=dev, logger=logger, checkpoint_path=ckpt)
            report = evaluate(res.states, test, res.final_loglik)
            t_serve = time.perf_counter()
            served = serve_predict_interaction(res.states, ds.triplets)
            serve_s = time.perf_counter() - t_serve
            k1_launches = em_bdr.em_ensemble_stats.launches
            k2_launches = score.ensemble_score.launches
            sum_launches = block_sum.block_sum.launches
        ck = load_checkpoint(ckpt)
        assert ck["sweep"] == sweeps and tuple(ck["states"].theta.shape) == (S, G, K)

    print(f"[fit] dispatch {json.dumps(res.dispatch, sort_keys=True)}")
    assert res.dispatch["kernel"] == em_bdr.KERNEL_NAME, res.dispatch
    assert k1_launches >= sweeps and sum_launches == k1_launches, (k1_launches, sum_launches)
    assert k2_launches >= 1, k2_launches
    trace = res.ll_trace
    assert trace.shape == (sweeps // 10, S) and np.isfinite(trace).all()
    drop = _max_drop(trace)
    print(f"[fit] L trace (best restart per check): {trace.max(axis=1).tolist()}")
    print(f"[fit] largest relative L drop {drop:.3e} (tol {LL_DROP_RTOL:g})")
    assert drop <= LL_DROP_RTOL
    assert np.isfinite(res.final_loglik).all()
    print(f"[eval] {json.dumps(report.to_dict(), sort_keys=True)}")
    assert np.isfinite(report.auc) and report.auc > 0.5, report.auc
    assert served.shape == (N,) and np.isfinite(served).all()
    assert served.min() >= 0.0 and served.max() <= 1.0
    n_real = train.n_real
    print(f"[fit] {res.sweeps_run / res.wall_seconds:.2f} sweeps/s, "
          f"{res.sweeps_run * S * n_real / res.wall_seconds:.4e} restart-triplet "
          f"updates/s (S={S}, {n_real} train rows; {card})")
    print(f"[serve] {N / serve_s:.4e} rows/s over {N} rows, S={S} ({card})")

    # Agreement with the plain path on a small input (not counted above).
    small, _, _ = sample_synthetic_dataset(4096, 200, K, n_ratings=R, seed=4)
    small_cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, sweeps=20, samples=4, likelihood_freq=5, checkpoint_every=0, seed=5,
    ))
    quiet = JsonlLogger(None, echo=False)
    via_kernel = fit(small_cfg, small, device=dev, logger=quiet)
    via_plain = fit(small_cfg, small, device=dev, logger=quiet, stats_fn=plain_stats)
    assert via_kernel.dispatch["kernel"] == em_bdr.KERNEL_NAME
    np.testing.assert_allclose(
        via_kernel.final_loglik, via_plain.final_loglik, rtol=FIT_RTOL
    )
    print(f"[fit] small fit, kernel vs plain final L within rtol {FIT_RTOL:g}: "
          f"{via_kernel.final_loglik.tolist()} vs {via_plain.final_loglik.tolist()}")

    # 7. the K-sweep job through the CLI, then serving the K = 50 unit
    k_grid = [int(x) for x in SWEEP_GRID.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synth.npz")
        assert cli_main(["synth", "-o", data, "-n", str(N), "-g", str(G), "-k", str(K),
                         "--ratings", str(R), "--seed", "0"]) == 0
        out_dir = os.path.join(tmp, "sweep")
        em_bdr.em_ensemble_stats.launches = 0
        em_large_k.em_ensemble_stats.launches = 0
        score.ensemble_score.launches = 0
        t_job = time.perf_counter()
        assert cli_main(["sweep", "-f", data, "--k-grid", SWEEP_GRID, "-s", str(S),
                         "-i", str(SWEEP_SWEEPS), "-n", "10", "-o", out_dir,
                         "--device", "cuda"]) == 0
        job_s = time.perf_counter() - t_job
        ck50 = load_checkpoint(os.path.join(out_dir, "units", "fold0_k50.ckpt.npz"), dev)
        sweep_ds = TripletDataset.load_npz(data)
        served50 = serve_predict_interaction(ck50["states"], sweep_ds.triplets)
        sweep_launches = {
            "em_sweep": em_bdr.em_ensemble_stats.launches,
            "em_sweep_large_k": em_large_k.em_ensemble_stats.launches,
            "score": score.ensemble_score.launches,
        }
        with open(os.path.join(out_dir, "report.json")) as fh:
            sweep_report = json.load(fh)
        traces = {
            k: load_checkpoint(os.path.join(out_dir, "units", f"fold0_k{k}.ckpt.npz"))["ll_trace"]
            for k in k_grid
        }
        # 7b. K3's top K through the CLI, on the same data
        top_dir = os.path.join(tmp, "fit72")
        em_large_k.em_ensemble_stats.launches = 0
        assert cli_main(["fit", "-f", data, "-k", str(em_large_k.MAX_K), "-s", str(S),
                         "-i", str(K3_TOP_SWEEPS), "-n", "5", "-o", top_dir,
                         "--device", "cuda"]) == 0
        top_launches = em_large_k.em_ensemble_stats.launches
        with open(os.path.join(top_dir, "events.jsonl")) as fh:
            top_events = [json.loads(line) for line in fh]
        top_trace = load_checkpoint(os.path.join(top_dir, "model.ckpt.npz"))["ll_trace"]
    print(f"[sweep] {json.dumps(sweep_report['summary'], sort_keys=True)}")
    print(f"[sweep] launches during the job and the K=50 serve: {sweep_launches}; "
          f"job wall {job_s:.2f} s")
    for rec in sweep_report["units"]:
        k = rec["k"]
        want_kernel = em_bdr.KERNEL_NAME if k <= 20 else em_large_k.KERNEL_NAME
        drop = _max_drop(traces[k])
        print(f"[sweep] {rec['unit']}: kernel {rec['dispatch']['kernel']}, "
              f"{rec['sweeps']} sweeps, {rec['triplets_per_sec'] * S:.4e} restart-triplet "
              f"updates/s (S={S}; {card}), heldout L {rec['heldout_loglik']:.6g}, "
              f"AUC {rec['auc']:.4f}, largest relative L drop {drop:.3e}")
        assert rec["dispatch"]["kernel"] == want_kernel, rec["dispatch"]
        assert rec["sweeps"] == SWEEP_SWEEPS
        assert traces[k].shape == (SWEEP_SWEEPS // 10, S) and np.isfinite(traces[k]).all()
        assert drop <= LL_DROP_RTOL, (k, drop)
    assert sorted(r["k"] for r in sweep_report["units"]) == k_grid
    summary = sweep_report["summary"]
    assert summary["best_k_per_fold"]["0"] in k_grid
    assert np.isfinite(summary["mean_auc_selected"])
    n_large = sum(1 for k in k_grid if k > 20)
    assert sweep_launches["em_sweep_large_k"] >= n_large * SWEEP_SWEEPS
    assert sweep_launches["em_sweep"] >= SWEEP_SWEEPS * (len(k_grid) - n_large)
    assert sweep_launches["score"] >= 1
    assert served50.shape == (N,) and np.isfinite(served50).all()
    assert served50.min() >= 0.0 and served50.max() <= 1.0
    print(f"[sweep] served {N} rows from the K=50 unit through {score.KERNEL_NAME}")
    top_disp = next(e for e in top_events if e["event"] == "dispatch")
    top_done = next(e for e in top_events if e["event"] == "fit_done")
    top_drop = _max_drop(top_trace)
    print(f"[K={em_large_k.MAX_K} fit] dispatch {json.dumps(top_disp, sort_keys=True)}; "
          f"launches {top_launches}; L trace (best restart) {top_trace.max(axis=1).tolist()}, "
          f"largest relative L drop {top_drop:.3e}; "
          f"{top_done['sweeps'] / top_done['wall_s']:.3f} sweeps/s, "
          f"{top_done['triplets_per_sec'] * S:.4e} restart-triplet updates/s (S={S}; {card})")
    assert top_disp["kernel"] == em_large_k.KERNEL_NAME, top_disp
    assert top_launches >= K3_TOP_SWEEPS, top_launches
    assert top_trace.shape == (K3_TOP_SWEEPS // 5, S) and np.isfinite(top_trace).all()
    assert top_drop <= LL_DROP_RTOL, top_drop

    # 8. the large-G fit
    large_g_kernels = large_g_phase(card, dev, cli_main)

    # 9. stepwise EM
    k7_kernel, stepwise_counts = stepwise_phase(card, dev, cli_main)

    # 10. the rating-sorted fit
    k9_kernel = rsorted_phase(card, dev, ds, train, res)

    # 11. the quality knobs
    quality_counts = quality_phase(card, dev, cli_main, ds, train, res)

    # 12. the multi-rank engine: torchrun worlds on the one card
    dist_counts = distributed_phase(card, dev, cli_main, train, res)
    k7_kernel["launches"] += dist_counts[em_hybrid.KERNEL_NAME]

    # 13. the bench entry point: bench, bench --serve, the records' shapes,
    # bench_quality at both quality records
    bench_counts = bench_phase(card, here, cli_main, res.sweeps_run / res.wall_seconds)

    # 14. the same bits from run to run
    determinism_phase(card, dev, train, res)

    # 15. the studies of tools/ at a small size
    studies_phase(card)
    sums = _time_block_sum(card, dev)
    sums["launches"] = sum_launches + bench_counts.get(BLOCK_SUM, 0)

    src = "trigenicinteractionpredictor_tpu_torch/csrc/"
    ref = "trigenicinteractionpredictor_tpu/ops/"
    k3_50, k3_top = k3_times[50], k3_times[em_large_k.MAX_K]
    k2_head = k2[K]
    kernels = [
        {
            "name": "em_sweep", "route": "cuda", "source": src + "em_sweep.cu",
            "replaces": ref + "pallas_em_bdr.py:279",
            "launches": k1_launches + sweep_launches["em_sweep"]
            + stepwise_counts[em_bdr.KERNEL_NAME] + quality_counts[em_bdr.KERNEL_NAME]
            + dist_counts[em_bdr.KERNEL_NAME],
            "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None,
        },
        {
            "name": "score", "route": "cuda", "source": src + "score.cu",
            "replaces": ref + "pallas_score.py:120",
            "launches": k2_launches + sweep_launches["score"]
            + stepwise_counts[score.KERNEL_NAME] + quality_counts[score.KERNEL_NAME],
            "max_abs_err": k2_err, "ms": k2_head["ms"], "plain_ms": k2_head["plain_ms"],
            "bound_ms": k2_head["bound_ms"], "bound_by": k2_head["bound_by"],
            "library_ms": k2_head["library_ms"], "at_k50_rows32768": k2[50],
        },
        {
            "name": "em_sweep_large_k", "route": "cuda", "source": src + "em_sweep_large_k.cu",
            "replaces": ref + "pallas_em.py:180",
            "launches": sweep_launches["em_sweep_large_k"] + top_launches,
            "max_abs_err": k3_err,
            "ms": k3_50[0], "plain_ms": k3_50[1], "bound_ms": k3_50[2][0],
            "bound_by": k3_50[2][1], "library_ms": None,
            "pass1_ms": k3_50[3]["pass1"], "pass2_ms": k3_50[3]["pass2"],
            "at_k72": {"ms": k3_top[0], "plain_ms": k3_top[1], "bound_ms": k3_top[2][0],
                       "bound_by": k3_top[2][1], "pass1_ms": k3_top[3]["pass1"],
                       "pass2_ms": k3_top[3]["pass2"]},
            "at_k64_g4000": {"ms": k8_ms, "plain_ms": k8_plain, "bound_ms": k8_bound[0],
                             "bound_by": k8_bound[1]},
        },
        *large_g_kernels,
        k7_kernel,
        k9_kernel,
        sums,
    ]
    assert len(kernels) == 10
    # Phase 13's launches: K5a's (em_streams) ran on the large-G route (S = 1).
    by_row = {"em_sweep": em_bdr.KERNEL_NAME, "score": score.KERNEL_NAME,
              "em_sweep_large_k": em_large_k.KERNEL_NAME, "em_bdg": em_bdg.ESTEP_NAME,
              "plan_scatter": em_bd.SCATTER_NAME, "large_g": em_bd.STREAMS_NAME}
    for kern in kernels:
        kern["launches"] += bench_counts.get(by_row.get(kern["name"].split()[0]), 0)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(json.loads(sys.argv[2])))
    sys.exit(main())
