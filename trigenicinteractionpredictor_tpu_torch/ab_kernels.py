"""Time the kernels of two source trees of the port on one GPU, in turns.

    python -m trigenicinteractionpredictor_tpu_torch.ab_kernels --parent DIR

``DIR`` holds another checkout of the repository (say ``git archive`` of
the parent commit, unpacked into a git-ignored directory).  Each tree is
timed in a process of its own, which imports the port from that tree and
builds its kernels there, in the order parent, change, change, parent, so
that a drift of the card shows as a difference between the two runs of one
tree.  Timed, by CUDA events after a warm-up, at the shapes of PERF.md's
kernel table (N = 131,072 rows, R = 2):

- K2 ``score.ensemble_score`` at K = 10 (131,072 rows, G = 1000, S = 10)
  and K = 50 (32,768 rows);
- K5b ``em_bd.plan_scatter`` on 2 positions of g1-ordered rows at
  G = 100,000, S = 10 (S*K = 100), and on 3 positions at S = 1 (S*K = 10,
  K6's second stage);
- K1 ``em_bdr.em_ensemble_stats`` at the headline shape (K = 10,
  G = 1000, S = 10);
- K3 ``em_large_k.em_ensemble_stats`` at K = 50 and 72 (G = 1000, S = 10)
  on a classic fit's batch (the route's ``Sweep.batch``, with its stream
  plan; in a tree whose routes are bare functions, the same plan built
  as that tree's trainer built it), and its two passes apart at
  K = 25, 50 and 72 (``torch.profiler`` device time of the kernels named
  ``estep_kernel`` and ``cross_kernel``, and of everything else the call
  launches, per call);
- K7 ``em_hybrid.hybrid_stats`` at K = 25 (G = 6000, S = 2);
- K4 ``em_bdg.bdg_estep`` on g1-ordered rows at G = 100,000, S = 10,
  with its tiles a restart beside it (``K4 G=100000 tiles``: tiles, those
  that cross a gene block's end, those cut by a second block's end, by
  ``em_bdg.bdg_tile_census``, in a tree that has it);
- K5a ``em_bd.em_streams`` at G = 500,000, S = 10;
- K9 ``em_rsorted.rsorted_em_ensemble_stats`` at K = 10 on plan tiles of
  512 rows (G = 1000, S = 10);
- K5b on 3 positions at K3's shape (K = 50, G = 1000, S = 10) and K7's
  (K = 25, G = 6000, S = 2), with ``index_add_`` of the same slots and the
  bound (``K5b ... index_add_``, ``K5b ... bound``);
- the bench's step (``bench.measure_engine``, updates/s at S = 10) at the
  args of the records ``ensemble_s10_k10`` and ``large_k50_s10``.

Beside each kernel's time, a digest of its outputs at the fixed seed
(``digest <name>``: SHA-256 of the bytes of theta_hat, p_hat and loglik,
or of whatever the call returns), and for K1, K3 at K = 50 and K7 one call
under ``torch.profiler`` (``profile <name>``: device ms, host-to-device
and device-to-host copies, stream syncs).  Prints one JSON line per run
and a summary line with every run's numbers, ``same_bits`` (each kernel's
digest equal in all four runs) and the card's name and power limit.
Needs a GPU; uses only entry points both trees have.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N, R = 131_072, 2


def _time_ms(fn, reps: int) -> float:
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


def pass_split(fn, reps: int) -> dict:
    """Device ms per call of K3's pass 1 (``estep_kernel``), pass 2
    (``cross_kernel``) and of everything else ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {"pass1": 0.0, "pass2": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us:
            continue
        key = ("pass1" if "estep_kernel" in ev.key else
               "pass2" if "cross_kernel" in ev.key else "other")
        split[key] += us / 1e3 / reps
    return split


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _profiled(fn) -> dict:
    """Device ms, host-to-device and device-to-host copies (the device
    activities ``Memcpy HtoD`` / ``Memcpy DtoH``) and the runtime's
    synchronize calls in one profiler window around ``fn()`` and the
    synchronize that closes the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"device_ms": 0.0, "htod": 0, "dtoh": 0, "syncs": 0}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if ev.key.startswith("Memcpy HtoD"):
            out["htod"] += ev.count
        elif ev.key.startswith("Memcpy DtoH"):
            out["dtoh"] += ev.count
        elif ev.key in SYNC_CALLS:
            out["syncs"] += ev.count
        out["device_ms"] += (us or 0.0) / 1e3
    return out


def call_profile(fn, windows: int = 3) -> dict:
    """One call of ``fn`` after a warm-up, under ``torch.profiler``: its
    device ms, its host-to-device and device-to-host copies and its stream
    syncs, less those of an empty window (the synchronize that closes it).
    The profiler can miss a window's device activity (no device time at
    all, so no copy either); such a window is discarded and the call
    profiled again, up to ``windows`` times (``windows``: how many it
    took; 0 device ms if none saw the device)."""
    import torch

    fn()
    torch.cuda.synchronize()
    empty = _profiled(lambda: None)
    for n in range(1, windows + 1):
        out = _profiled(fn)
        if out["device_ms"] > 0:
            break
    for key in ("htod", "dtoh", "syncs"):
        out[key] -= empty[key]
    out["windows"] = n
    return out


def digest(result) -> str:
    """The first 16 hex digits of a SHA-256 over the bytes of every tensor
    in ``result`` (a tensor, or a tuple of them such as SweepStats), in
    order: equal digests mean equal bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in (result,) if isinstance(result, torch.Tensor) else result:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _bound_ms(flops: float, nbytes: float) -> float:
    """The least ms the card could take: float32 operations over 67 TFLOP/s
    or bytes over 3.35 TB/s (the H100 SXM data sheet), the larger."""
    return 1e3 * max(flops / 67e12, nbytes / 3.35e12)


def measure(tree: str, only=()) -> dict:
    """The timings of the port found in ``tree`` (ms; updates/s for the
    bench lines), each kernel's output digest at this fixed seed
    (``digest ...``) and one call of K1, K3 and K7 under the profiler
    (``profile ...``: :func:`call_profile`); with ``only``, just the
    entries whose names start with one of its prefixes."""
    sys.path[0] = tree  # in place of this file's directory
    import torch

    import trigenicinteractionpredictor_tpu_torch as port
    from trigenicinteractionpredictor_tpu_torch import bench
    from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu_torch.ops import (
        _build,
        dispatch,
        em_bd,
        em_bdg,
        em_bdr,
        em_hybrid,
        em_large_g,
        em_large_k,
        em_rsorted,
        score,
    )
    from trigenicinteractionpredictor_tpu_torch.ops.em import make_batch

    assert os.path.abspath(port.__file__).startswith(os.path.join(os.path.abspath(tree), ""))
    dev = torch.device("cuda")
    torch.manual_seed(0)
    _build.library()
    out = {}

    def want(name):
        return not only or name.startswith(tuple(only))

    def timed(name, fn, reps):
        out[f"digest {name}"] = digest(fn())
        out[name] = _time_ms(fn, reps)

    for k, rows in ((10, N), (50, 32_768)):
        if not want(f"K2 K={k}"):
            continue
        ds, _, _ = sample_synthetic_dataset(rows, 1000, 10, n_ratings=R, seed=2)
        st = init_state(1000, k, R, samples=10, seed=3, device=dev)
        trips = torch.as_tensor(ds.triplets, dtype=torch.int32, device=dev)
        timed(f"K2 K={k}", lambda: score.ensemble_score(st.theta, st.p, trips), 20)

    # K5b: 2 positions at G = 100,000, S = 10 (K4's), 3 at S = 1 (K6's); and
    # 3 positions at K3's shape (K = 50, G = 1000, S = 10) and K7's (K = 25,
    # G = 6000, S = 2), with its bound and index_add_ of the same slots.
    for tag, g, s, k, positions in (("S=10", 100_000, 10, 10, (1, 2)),
                                    ("S=1", 100_000, 1, 10, (0, 1, 2)),
                                    ("K3 shape", 1000, 10, 50, (0, 1, 2)),
                                    ("K7 shape", 6000, 2, 25, (0, 1, 2))):
        if not want(f"K5b {tag}"):
            continue
        ds, _, _ = sample_synthetic_dataset(N, g, 10, n_ratings=R, seed=5)
        trip = ds.triplets
        if len(positions) == 2:
            g1 = em_bdg.make_g1_plan(trip, g, wb1=em_bdg.bdg_plan(10, R)[1])
            trip = em_bdg.apply_g1_order(g1, trip, ds.ratings, ds.weights)[0]
        plan = em_large_g.make_scatter_plan(trip, g, positions=positions)
        tb = make_batch(trip, ds.ratings, ds.weights, dev, scatter=plan)
        gen = torch.Generator(device=dev).manual_seed(11)
        streams = torch.rand((len(positions), N, s * k), device=dev, generator=gen)
        args = (tb.scatter_perm, tb.scatter_lid, tb.scatter_offsets, em_bd.DEFAULT_WB, g, k)
        timed(f"K5b {tag}", lambda: em_bd.plan_scatter(streams, *args), 50)
        if tag.endswith("shape"):
            slots = len(positions) * N
            genes = torch.as_tensor(trip[:, list(positions)].T.reshape(-1), dtype=torch.long,
                                    device=dev)
            vals = streams.reshape(slots, s * k)
            acc = torch.zeros((g, s * k), device=dev)
            out[f"K5b {tag} index_add_"] = _time_ms(lambda: acc.index_add_(0, genes, vals), 50)
            out[f"K5b {tag} bound"] = _bound_ms(float(slots * s * k),
                                               4.0 * slots * s * k + 8.0 * slots + 4.0 * s * g * k)
            del genes, vals, acc
        del streams, tb
        torch.cuda.empty_cache()

    for name, k, g, s in (("K1 K=10", 10, 1000, 10), ("K3 K=25", 25, 1000, 10),
                          ("K3 K=50", 50, 1000, 10), ("K3 K=72", 72, 1000, 10),
                          ("K7 K=25", 25, 6000, 2)):
        if not want(name):
            continue
        ds, _, _ = sample_synthetic_dataset(N, g, 10, n_ratings=R, seed=9)
        st = init_state(g, k, R, samples=s, seed=10, device=dev)
        if name.startswith("K3"):  # a classic fit's batch, with its stream plan
            sweep = dispatch.stats_fn_for(em_large_k.KERNEL_NAME, k, R)
            if hasattr(sweep, "batch"):
                tb = sweep.batch(ds, dev)[0]
            else:  # a tree whose routes are bare functions: the plan its trainer built
                tb = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
                tb = em_large_k.with_stream_plan(tb, em_large_k.stream_plan(
                    tb.triplets, tb.ratings, R, ds.n_genes))
        else:
            tb = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
        if name.startswith("K1"):
            fn = lambda: em_bdr.em_ensemble_stats(st.theta, st.p, tb)  # noqa: E731
        elif name.startswith("K3"):
            fn = lambda: em_large_k.em_ensemble_stats(st.theta, st.p, tb)  # noqa: E731
            out[f"{name} passes"] = pass_split(fn, 2)
        else:
            th = em_hybrid.gather_rows(st.theta, tb.triplets)
            fn = lambda: em_hybrid.hybrid_stats(  # noqa: E731
                *th, tb.triplets, tb.ratings, tb.weights, st.p, g)
        if name in ("K1 K=10", "K3 K=50", "K7 K=25"):
            out[f"profile {name}"] = call_profile(fn)
        if name != "K3 K=25":
            timed(name, fn, 20 if k <= 25 else 5)
        del st, tb
        torch.cuda.empty_cache()

    for name, g in (("K4 G=100000", 100_000), ("K5a G=500000", 500_000)):
        if not want(name):
            continue
        ds, _, _ = sample_synthetic_dataset(N, g, 10, n_ratings=R, seed=5)
        st = init_state(g, 10, R, samples=10, seed=6, device=dev)
        if name.startswith("K4"):
            wb1 = em_bdg.bdg_plan(10, R)[1]
            g1 = em_bdg.make_g1_plan(ds.triplets, g, wb1=wb1)
            tb = make_batch(*em_bdg.apply_g1_order(g1, ds.triplets, ds.ratings, ds.weights),
                            dev, g1=g1)
            fn = lambda: em_bdg.bdg_estep(st.theta, st.p, tb, wb1)  # noqa: E731
            if hasattr(em_bdg, "bdg_tile_census"):  # tiles a restart, crossing, cut
                tile = em_bdg.bdg_plan(10, R)[0]
                rows = em_bdg.bdg_pieces(N, 10, tile, em_bdr.sm_count(dev))[0]
                out[f"{name} tiles"] = list(em_bdg.bdg_tile_census(g1.offsets, N, rows, tile))
        else:
            tb = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
            fn = lambda: em_bd.em_streams(st.theta, st.p, tb)  # noqa: E731
        timed(name, fn, 20)
        del st, tb
        torch.cuda.empty_cache()

    if want("K9 tile=512"):
        ds, _, _ = sample_synthetic_dataset(N, 1000, 10, n_ratings=R, seed=9)
        st = init_state(1000, 10, R, samples=10, seed=10, device=dev)
        plan = em_rsorted.rating_sort_pad(ds.ratings, R, tile=512)
        rows = em_rsorted.apply_rating_sort(plan, ds.triplets, ds.ratings, ds.weights)
        tb = make_batch(*rows, dev, tile_rating=plan.tile_r)
        timed("K9 tile=512",
              lambda: em_rsorted.rsorted_em_ensemble_stats(st.theta, st.p, tb, 512), 20)
        del st, tb
        torch.cuda.empty_cache()

    # The bench at the headline record's args and at large_k50_s10's
    # (tests/perf_records.json): updates/s at S = 10.
    for name, argv in (("bench headline", ["--sweeps", "60"]),
                       ("bench large_k50_s10", ["-k", "50", "--sweeps", "30", "-n", "32768"])):
        if not want(name):
            continue
        runs = bench.measure_engine(bench.parse_args(argv + ["--device", "cuda"]))
        out[name] = runs[-1].updates_per_sec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--tree", help="(worker) time the port found in this checkout")
    ap.add_argument("--only", default="",
                    help="comma-separated name prefixes (e.g. 'K1,K9,bench headline'): "
                         "time just those")
    args = ap.parse_args(argv)
    if args.tree:
        print(json.dumps(measure(args.tree, [x for x in args.only.split(",") if x])))
        return 0
    if not args.parent:
        ap.error("--parent DIR is required")
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: needs one GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = []
    parent = os.path.abspath(args.parent)
    for label, tree in (("parent", parent), ("change", here), ("change", here),
                        ("parent", parent)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree,
                              "--only", args.only], capture_output=True, text=True, cwd=tree)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append((label, ms))
        print(json.dumps({"tree": label, "ms": ms}), flush=True)
    names = dict.fromkeys(name for _, ms in runs for name in ms)
    summary = {name: [ms.get(name) for _, ms in runs] for name in names}
    same = {name[len("digest "):]: len(set(v)) == 1
            for name, v in summary.items() if name.startswith("digest ")}
    print(json.dumps({"order": [label for label, _ in runs], "ms": summary,
                      "same_bits": same, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
