"""Measure the stepwise (beyond-HBM) path's per-epoch HOST cost at scale.

The streaming stepwise trainer preps every minibatch on the host each
epoch (``train/stream_prep.py``): the (seed, epoch) shuffle of the padded
index space, the gather of each minibatch's rows from the memmapped store
and, for a stats function that needs rating-sorted rows, one stable
rating sort per minibatch into its tile layout.  This tool times three
pipelines on a synthetic memmapped store and prints one JSON line per
pipeline, with the host seconds of each stage:

- ``legacy`` -- a serial int64 permutation, a masked fancy-index gather per
  dispatch group and a Python loop of rating sorts (the reference's round-4
  pipeline): ``t_perm_s``, ``t_gather_s``, ``t_rsort_s``;
- ``r5-inthread`` -- ``epoch_perm`` and ``_prep_minibatches`` on this
  thread, the code a one-worker ``StreamPrep`` runs (the split inside a
  worker): ``t_perm_s``, ``t_gather_s`` (``_gather_rows``), ``t_rsort_plan_s``
  (``rating_sort_pad``) and ``t_rsort_apply_s`` (``apply_rating_sort``);
- ``pooled-N`` -- ``StreamPrep`` with N spawn workers: ``t_perm_s`` (the
  parent's draw of the epoch's permutation) and ``t_wait_s`` (the parent
  waiting on the workers).

Every line's stages add up to no more than its ``host_total_s``.  Beside
each it puts the device time of an epoch at the card's own rate of K1 (the
sweep kernel stepwise EM runs at K <= 20), timed here at the minibatch
shape with ``--device cuda``, or taken from ``--device-rows-per-s``; with
neither (``--device cpu``) the device keys are null and the line holds
host seconds only.  No rate taken on another accelerator is assumed.

Usage:
    python -m trigenicinteractionpredictor_tpu_torch.tools.stepwise_host_cost \
        [--n 10000000] [--mb 131072] [--workers N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
import types

import numpy as np

from trigenicinteractionpredictor_tpu_torch.ops import rsort_plan
from trigenicinteractionpredictor_tpu_torch.train import stream_prep
from trigenicinteractionpredictor_tpu_torch.train.stream_prep import (
    StreamPrep,
    _prep_minibatches,
    epoch_perm,
)


def arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--genes", type=int, default=2000)
    ap.add_argument("--mb", type=int, default=131072)
    ap.add_argument("--group", type=int, default=8, help="stream_groups")
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--ratings", type=int, default=2)
    ap.add_argument("--workers", type=int, default=0,
                    help="pool size for the pooled pipeline (0 = cpu-1)")
    ap.add_argument("--skip-legacy", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda: time K1 at the minibatch shape for the device rate; "
                         "cpu: no device rate unless --device-rows-per-s")
    ap.add_argument("--device-rows-per-s", type=float, default=0.0,
                    help="a device rate (minibatch rows/s) measured elsewhere")
    ap.add_argument("-k", type=int, default=10, help="K of the timed K1 sweep")
    ap.add_argument("-s", "--samples", type=int, default=10,
                    help="restarts of the timed K1 sweep")
    return ap


def k1_rows_per_s(device, mb: int, genes: int, k: int, samples: int, ratings: int) -> dict:
    """Minibatch rows/s of K1 (``ops/em_bdr.py``) on the card at one
    minibatch's shape, by CUDA events over 20 calls after a warm-up."""
    import torch

    from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset
    from trigenicinteractionpredictor_tpu_torch.device import resolve_device
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu_torch.ops import em_bdr
    from trigenicinteractionpredictor_tpu_torch.ops.em import make_batch

    dev = resolve_device(device)
    ds, _, _ = sample_synthetic_dataset(mb, genes, k, n_ratings=ratings, seed=0)
    st = init_state(genes, k, ratings, samples=samples, seed=0, device=dev)
    batch = make_batch(ds.triplets, ds.ratings, ds.weights, dev)

    def sweep():
        return em_bdr.em_ensemble_stats(st.theta, st.p, batch)

    sweep()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 20
    start.record()
    for _ in range(reps):
        sweep()
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / reps
    return {"rows_per_s": mb / (ms / 1e3), "k1_ms": ms, "k": k, "samples": samples,
            "card": torch.cuda.get_device_name(dev)}


def report(tag: str, n: int, detail: dict, stages: dict, host_total: float,
           device_rows_per_s: float) -> dict:
    """One pipeline's JSON line (the reference's keys, the stages beside)."""
    dev_epoch = n / device_rows_per_s if device_rows_per_s else None
    line = {
        "pipeline": tag,
        **detail,
        **{name: round(sec, 4) for name, sec in stages.items()},
        "host_total_s": round(host_total, 4),
        "host_rows_per_s": round(n / host_total),
        "device_epoch_s_bdr_est": None if dev_epoch is None else round(dev_epoch, 4),
        "host_over_device_bdr": None if dev_epoch is None else round(host_total / dev_epoch, 2),
        # The reference's one-hot ensemble kernel has no counterpart here:
        # stepwise EM at K <= 20 runs K1 on every minibatch.
        "host_over_device_onehot": None,
    }
    print(json.dumps(line), flush=True)
    return line


@contextlib.contextmanager
def _timed(module, names, acc: dict):
    """Time every call of ``module.<name>`` into ``acc[name]`` (seconds)."""
    saved = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[name] += time.perf_counter() - t0
        return timed

    for name in names:
        acc.setdefault(name, 0.0)
        setattr(module, name, wrap(name, saved[name]))
    try:
        yield acc
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def write_store(td: str, n: int, genes: int, ratings: int):
    """A synthetic packed store as .npy files (pool workers reopen them by
    path), reopened read-only as memmaps, like ``load_dir(mmap=True)``."""
    from numpy.lib.format import open_memmap

    rng = np.random.default_rng(0)
    paths = {name: os.path.join(td, f"{name}.npy") for name in ("triplets", "ratings", "weights")}
    trip = open_memmap(paths["triplets"], mode="w+", dtype=np.int32, shape=(n, 3))
    rat = open_memmap(paths["ratings"], mode="w+", dtype=np.int32, shape=(n,))
    wts = open_memmap(paths["weights"], mode="w+", dtype=np.float32, shape=(n,))
    chunk = 4_000_000
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        trip[lo:hi] = rng.integers(0, genes, size=(hi - lo, 3), dtype=np.int32)
        rat[lo:hi] = rng.integers(0, ratings, size=hi - lo, dtype=np.int32)
        wts[lo:hi] = 1.0
    for a in (trip, rat, wts):
        a.flush()
    return tuple(np.load(paths[name], mmap_mode="r") for name in ("triplets", "ratings", "weights"))


def main(argv=None) -> int:
    args = arg_parser().parse_args(argv)
    rate = args.device_rows_per_s
    if args.device != "cpu":
        k1 = k1_rows_per_s(args.device, args.mb, args.genes, args.k, args.samples, args.ratings)
        rate = k1["rows_per_s"]
        print(json.dumps({"device_rate": k1}), flush=True)

    N, mb, group, R = args.n, args.mb, args.group, args.ratings
    lines = []
    with tempfile.TemporaryDirectory() as td:
        trip_mm, rat_mm, wts_mm = write_store(td, N, args.genes, R)
        n_padded = -(-N // mb) * mb
        n_mb = n_padded // mb
        while n_mb % group:       # mirror the trainer: largest divisor <= req
            group -= 1
        n_dispatch = n_mb // group
        d_sh = args.shards
        ft = (mb // d_sh) // args.tile + R
        mb_b = ft * args.tile * d_sh
        layout = {
            "seed": 1, "n": N, "n_padded": n_padded, "mb": mb, "mb_b": mb_b,
            "group": group, "arity": 3, "rsort": True, "n_ratings": R,
            "tile": args.tile, "n_shards": d_sh, "n_tiles": ft,
        }
        detail = {"n": N, "mb": mb, "group": group, "tile": args.tile,
                  "padded_mb_rows": mb_b}

        if not args.skip_legacy:
            t0 = time.perf_counter()
            perm = np.random.default_rng(1).permutation(n_padded)
            t_perm = time.perf_counter() - t0
            t_gather = t_sort = 0.0
            for d in range(n_dispatch):
                gp = perm[d * group * mb:(d + 1) * group * mb]
                t0 = time.perf_counter()
                trip = np.zeros((len(gp), 3), np.int32)
                rat = np.zeros(len(gp), np.int32)
                wts = np.zeros(len(gp), np.float32)
                mask = gp < N
                trip[mask] = trip_mm[gp[mask]]
                rat[mask] = rat_mm[gp[mask]]
                wts[mask] = wts_mm[gp[mask]]
                t_gather += time.perf_counter() - t0
                t0 = time.perf_counter()
                for m in range(group):
                    sl = slice(m * mb, (m + 1) * mb)
                    plan = rsort_plan.rating_sort_pad(rat[sl], R, tile=args.tile,
                                                      n_shards=d_sh, n_tiles=ft)
                    rsort_plan.apply_rating_sort(plan, trip[sl], rat[sl], wts[sl],
                                                 n_shards=d_sh)
                t_sort += time.perf_counter() - t0
            lines.append(report(
                "legacy", N, detail,
                {"t_perm_s": t_perm, "t_gather_s": t_gather, "t_rsort_s": t_sort},
                t_perm + t_gather + t_sort, rate))

        acc: dict = {}
        ds_arrays = (trip_mm, rat_mm, wts_mm)
        with _timed(stream_prep, ("_gather_rows", "rating_sort_pad", "apply_rating_sort"), acc):
            t0 = time.perf_counter()
            perm5 = epoch_perm(1, 0, n_padded)
            t_perm = time.perf_counter() - t0
            for d in range(n_dispatch):
                _prep_minibatches(ds_arrays, layout, perm5[d * group * mb:(d + 1) * group * mb])
            t_inthread = time.perf_counter() - t0
        lines.append(report(
            "r5-inthread", N, detail,
            {"t_perm_s": t_perm, "t_gather_s": acc["_gather_rows"],
             "t_rsort_plan_s": acc["rating_sort_pad"],
             "t_rsort_apply_s": acc["apply_rating_sort"]},
            t_inthread, rate))

        workers = args.workers or max(1, (os.cpu_count() or 2) - 1)
        if workers >= 2:
            ds_obj = types.SimpleNamespace(triplets=trip_mm, ratings=rat_mm, weights=wts_mm)
            sp = StreamPrep(ds_obj, layout, workers=workers)
            try:
                if sp._pool is None:
                    print(json.dumps({"pipeline": f"pooled-{workers}",
                                      "error": f"pool failed to start: {sp.pool_error}"}))
                else:
                    sp.prep_group(0, 0)  # warm
                    t0 = time.perf_counter()
                    sp._perm(1)
                    t_perm = time.perf_counter() - t0
                    for d in range(n_dispatch):
                        sp.prep_group(1, d)
                    t_pool = time.perf_counter() - t0
                    lines.append(report(f"pooled-{workers}", N, detail,
                                        {"t_perm_s": t_perm, "t_wait_s": t_pool - t_perm},
                                        t_pool, rate))
            finally:
                sp.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
