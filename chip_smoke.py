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
               before and read just after.

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
