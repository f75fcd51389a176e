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
               headline N, G, R, S for K = 25, 50 and 64, with both times;
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
               and read just after.

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
# other orders (the kernel through atomics in run-dependent order); each
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
        row("em_streams", "em_streams.cu", "pallas_em_bd.py:215", bd_n[em_bd.STREAMS_NAME],
            bd["e_err"], bd, "estep", "estep_plain"),
        row("large_g (em_streams + plan_scatter at S = 1)", "em_streams.cu",
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
        em_rsorted.rsorted_em_ensemble_stats)}


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
    assert classic == {em_rsorted.KERNEL_NAME: sweeps}, classic
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
    assert stepwise == {em_rsorted.KERNEL_NAME: 2 * n_mb} and 2 * n_mb == 16, stepwise
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
    from trigenicinteractionpredictor_tpu_torch.ops import _build, em_bdr, em_large_k, score
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
        k3_times[k] = (ms, plain, bound)
        print(f"[K3] K={k}: {ms:.4f} ms/sweep-stats, plain {plain:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}) (N={N}, G={G}, R={R}, S={S}; {card})")
        del st
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
            res = fit(cfg, train, device=dev, logger=logger, checkpoint_path=ckpt)
            report = evaluate(res.states, test, res.final_loglik)
            t_serve = time.perf_counter()
            served = serve_predict_interaction(res.states, ds.triplets)
            serve_s = time.perf_counter() - t_serve
            k1_launches = em_bdr.em_ensemble_stats.launches
            k2_launches = score.ensemble_score.launches
        ck = load_checkpoint(ckpt)
        assert ck["sweep"] == sweeps and tuple(ck["states"].theta.shape) == (S, G, K)

    print(f"[fit] dispatch {json.dumps(res.dispatch, sort_keys=True)}")
    assert res.dispatch["kernel"] == em_bdr.KERNEL_NAME, res.dispatch
    assert k1_launches >= sweeps, k1_launches
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

    src = "trigenicinteractionpredictor_tpu_torch/csrc/"
    ref = "trigenicinteractionpredictor_tpu/ops/"
    k3_50, k3_top = k3_times[50], k3_times[em_large_k.MAX_K]
    k2_head = k2[K]
    kernels = [
        {
            "name": "em_sweep", "route": "cuda", "source": src + "em_sweep.cu",
            "replaces": ref + "pallas_em_bdr.py:279",
            "launches": k1_launches + sweep_launches["em_sweep"]
            + stepwise_counts[em_bdr.KERNEL_NAME],
            "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None,
        },
        {
            "name": "score", "route": "cuda", "source": src + "score.cu",
            "replaces": ref + "pallas_score.py:120",
            "launches": k2_launches + sweep_launches["score"]
            + stepwise_counts[score.KERNEL_NAME],
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
            "at_k72": {"ms": k3_top[0], "plain_ms": k3_top[1], "bound_ms": k3_top[2][0],
                       "bound_by": k3_top[2][1]},
        },
        *large_g_kernels,
        k7_kernel,
        k9_kernel,
    ]
    assert len(kernels) == 9
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
