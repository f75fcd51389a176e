#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device   -- needs CUDA; prints the card's name and power limit;
2. build    -- compiles the port's CUDA kernels from csrc/ with nvcc;
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
               through each of the three routes against the plain fit.

The line before the last holds the kernels' record as JSON (``launches``
sums the two counted paths); the last line is ``{"ok": true, "device":
{...}}``.
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
K3_GRID = (25, 50, 64)
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
        print(f"[{tag}] {shape}: sweep-stats {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, K1 {t['k1']:.4f} ms; E-step {t['estep']:.4f} ms "
              f"(plain {t['estep_plain']:.4f}); plan_scatter {t['scatter']:.4f} ms "
              f"(plain {t['scatter_plain']:.4f}) ({card})")
        rec[(kind, g, S)] = dict(t, e_err=e_err, s_err=s_err)
        del st, th, p, batch, plain_batch, streams, ds
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
    return [
        {"name": "em_bdg", "route": "cuda", "source": src + "em_bdg.cu",
         "replaces": ref + "pallas_em_bdg.py:289", "launches": job_counts[em_bdg.ESTEP_NAME],
         "max_abs_err": bdg["e_err"], "ms": bdg["estep"], "plain_ms": bdg["estep_plain"]},
        {"name": "plan_scatter", "route": "cuda", "source": src + "plan_scatter.cu",
         "replaces": ref + "pallas_em_bd.py:364",
         "launches": job_counts[em_bd.SCATTER_NAME] + bd_n[em_bd.SCATTER_NAME],
         "max_abs_err": max(r["s_err"] for r in rec.values()), "ms": bdg["scatter"],
         "plain_ms": bdg["scatter_plain"]},
        {"name": "em_streams", "route": "cuda", "source": src + "em_streams.cu",
         "replaces": ref + "pallas_em_bd.py:215", "launches": bd_n[em_bd.STREAMS_NAME],
         "max_abs_err": bd["e_err"], "ms": bd["estep"], "plain_ms": bd["estep_plain"]},
        {"name": "large_g (em_streams + plan_scatter at S = 1)", "route": "cuda",
         "source": src + "em_streams.cu", "replaces": ref + "pallas_em_large.py:275",
         "launches": lg_n[em_bd.STREAMS_NAME], "max_abs_err": max(s1["e_err"], s1["s_err"]),
         "ms": s1["kernel"], "plain_ms": s1["plain"]},
    ]


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
    print(f"[K1] {k1_ms:.4f} ms/sweep-stats, plain {k1_plain_ms:.4f} ms "
          f"(N={N}, G={G}, K={K}, R={R}, S={S}; {card})")
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
        k3_times[k] = (ms, plain)
        print(f"[K3] K={k}: {ms:.4f} ms/sweep-stats, plain {plain:.4f} ms "
              f"(N={N}, G={G}, R={R}, S={S}; {card})")
        del st
    torch.cuda.empty_cache()

    # 5. K2 against its plain version
    k2_err, k2_ms, k2_plain_ms = 0.0, None, None
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
        if (g, k) == (G, K):
            k2_ms, k2_plain_ms = ms, plain

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

    # 8. the large-G fit
    large_g_kernels = large_g_phase(card, dev, cli_main)

    kernels = [
        {
            "name": "em_sweep", "route": "cuda",
            "source": "trigenicinteractionpredictor_tpu_torch/csrc/em_sweep.cu",
            "replaces": "trigenicinteractionpredictor_tpu/ops/pallas_em_bdr.py:279",
            "launches": k1_launches + sweep_launches["em_sweep"], "max_abs_err": k1_err,
            "ms": k1_ms, "plain_ms": k1_plain_ms,
        },
        {
            "name": "score", "route": "cuda",
            "source": "trigenicinteractionpredictor_tpu_torch/csrc/score.cu",
            "replaces": "trigenicinteractionpredictor_tpu/ops/pallas_score.py:120",
            "launches": k2_launches + sweep_launches["score"], "max_abs_err": k2_err,
            "ms": k2_ms, "plain_ms": k2_plain_ms,
        },
        {
            "name": "em_sweep_large_k", "route": "cuda",
            "source": "trigenicinteractionpredictor_tpu_torch/csrc/em_sweep_large_k.cu",
            "replaces": "trigenicinteractionpredictor_tpu/ops/pallas_em.py:180",
            "launches": sweep_launches["em_sweep_large_k"], "max_abs_err": k3_err,
            "ms": k3_times[50][0], "plain_ms": k3_times[50][1],
        },
        *large_g_kernels,
    ]
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
