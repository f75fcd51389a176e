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
- K3 ``em_large_k.em_ensemble_stats`` at K = 50 and 72 (G = 1000, S = 10),
  and its two passes apart at K = 25, 50 and 72 (``torch.profiler``
  device time of the kernels named ``estep_kernel`` and ``cross_kernel``,
  and of everything else the call launches, per call);
- K7 ``em_hybrid.hybrid_stats`` at K = 25 (G = 6000, S = 2);
- K4 ``em_bdg.bdg_estep`` on g1-ordered rows at G = 100,000, S = 10;
- K5a ``em_bd.em_streams`` at G = 500,000, S = 10;
- K9 ``em_rsorted.rsorted_em_ensemble_stats`` at K = 10 on plan tiles of
  512 rows (G = 1000, S = 10).

Prints one JSON line per run and a summary line with the card's name and
power limit.  Needs a GPU; uses only entry points both trees have.
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


def measure(tree: str) -> dict:
    """The timings of the port found in ``tree``, in ms."""
    sys.path[0] = tree  # in place of this file's directory
    import torch

    import trigenicinteractionpredictor_tpu_torch as port
    from trigenicinteractionpredictor_tpu_torch.data import sample_synthetic_dataset
    from trigenicinteractionpredictor_tpu_torch.models.mmsbm import init_state
    from trigenicinteractionpredictor_tpu_torch.ops import (
        _build,
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
    _build.library()
    out = {}

    for k, rows in ((10, N), (50, 32_768)):
        ds, _, _ = sample_synthetic_dataset(rows, 1000, 10, n_ratings=R, seed=2)
        st = init_state(1000, k, R, samples=10, seed=3, device=dev)
        trips = torch.as_tensor(ds.triplets, dtype=torch.int32, device=dev)
        out[f"K2 K={k}"] = _time_ms(lambda: score.ensemble_score(st.theta, st.p, trips), 20)

    ds, _, _ = sample_synthetic_dataset(N, 100_000, 10, n_ratings=R, seed=5)
    for s, positions in ((10, (1, 2)), (1, (0, 1, 2))):
        trip = ds.triplets
        if len(positions) == 2:
            g1 = em_bdg.make_g1_plan(trip, 100_000, wb1=em_bdg.bdg_plan(10, R)[1])
            trip = em_bdg.apply_g1_order(g1, trip, ds.ratings, ds.weights)[0]
        plan = em_large_g.make_scatter_plan(trip, 100_000, positions=positions)
        tb = make_batch(trip, ds.ratings, ds.weights, dev, scatter=plan)
        streams = torch.rand((len(positions), N, s * 10), device=dev)
        args = (tb.scatter_perm, tb.scatter_lid, tb.scatter_offsets, em_bd.DEFAULT_WB,
                100_000, 10)
        out[f"K5b S={s}"] = _time_ms(lambda: em_bd.plan_scatter(streams, *args), 50)
    del streams, tb

    for name, k, g, s in (("K1 K=10", 10, 1000, 10), ("K3 K=25", 25, 1000, 10),
                          ("K3 K=50", 50, 1000, 10), ("K3 K=72", 72, 1000, 10),
                          ("K7 K=25", 25, 6000, 2)):
        ds, _, _ = sample_synthetic_dataset(N, g, 10, n_ratings=R, seed=9)
        st = init_state(g, k, R, samples=s, seed=10, device=dev)
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
        if name != "K3 K=25":
            out[name] = _time_ms(fn, 20 if k <= 25 else 5)
        del st, tb

    for name, g in (("K4 G=100000", 100_000), ("K5a G=500000", 500_000)):
        ds, _, _ = sample_synthetic_dataset(N, g, 10, n_ratings=R, seed=5)
        st = init_state(g, 10, R, samples=10, seed=6, device=dev)
        if name.startswith("K4"):
            wb1 = em_bdg.bdg_plan(10, R)[1]
            g1 = em_bdg.make_g1_plan(ds.triplets, g, wb1=wb1)
            tb = make_batch(*em_bdg.apply_g1_order(g1, ds.triplets, ds.ratings, ds.weights),
                            dev, g1=g1)
            fn = lambda: em_bdg.bdg_estep(st.theta, st.p, tb, wb1)  # noqa: E731
        else:
            tb = make_batch(ds.triplets, ds.ratings, ds.weights, dev)
            fn = lambda: em_bd.em_streams(st.theta, st.p, tb)  # noqa: E731
        out[name] = _time_ms(fn, 20)
        del st, tb
        torch.cuda.empty_cache()

    ds, _, _ = sample_synthetic_dataset(N, 1000, 10, n_ratings=R, seed=9)
    st = init_state(1000, 10, R, samples=10, seed=10, device=dev)
    plan = em_rsorted.rating_sort_pad(ds.ratings, R, tile=512)
    rows = em_rsorted.apply_rating_sort(plan, ds.triplets, ds.ratings, ds.weights)
    tb = make_batch(*rows, dev, tile_rating=plan.tile_r)
    out["K9 tile=512"] = _time_ms(
        lambda: em_rsorted.rsorted_em_ensemble_stats(st.theta, st.p, tb, 512), 20)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--tree", help="(worker) time the port found in this checkout")
    args = ap.parse_args(argv)
    if args.tree:
        print(json.dumps(measure(args.tree)))
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
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree],
                             capture_output=True, text=True, cwd=tree)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append((label, ms))
        print(json.dumps({"tree": label, "ms": ms}), flush=True)
    summary = {name: [ms.get(name) for _, ms in runs] for name in runs[0][1]}
    print(json.dumps({"order": [label for label, _ in runs], "ms": summary, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
