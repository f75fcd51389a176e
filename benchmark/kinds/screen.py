"""Traffic kind ``screen``: ranking untested triplets, a closed loop of
calls to the port's ``ops.scoring.serve_predict_interaction`` (numpy in,
numpy out), as the ``predict`` command calls it.

Traffic parameters: ``samples`` (restarts S of the scored ensemble),
``rows_per_call`` (candidate triplets a call), ``block_rows`` (the
scorer's block), ``pool_calls`` (distinct calls' worth of rows drawn in
set-up; the window cycles through them) and ``interact_rating``.

Set-up draws an S-restart ensemble of uniform-simplex rows and cells and
the pool of candidates (three distinct genes, uniform) on the device from
the seed, and copies the pool to the host, where a caller holds it.  The
scorer's route has to be the one the cell names, else the run is refused.
Per call the client records the host time and checks that the route's
kernel launched once a block.  The comparison scores a sample of the window's
calls, drawn from the seed, with the plain reference (float64) and takes
the largest absolute gap over all their rows.
"""

from __future__ import annotations

import math
import sys
import time

import torch
from torch.profiler import record_function

from benchmark import launches, reference, roofline, synth


class Client:
    def __init__(self, cell, seed: int, device: torch.device, control: bool = False):
        from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
        from trigenicinteractionpredictor_tpu_torch.ops import scoring

        c, t = cell.config, cell.traffic
        self.device, self.control = device, control
        self.g, self.k, self.r, self.s = c["n_genes"], c["k"], c["n_ratings"], t["samples"]
        self.n, self.block = t["rows_per_call"], t["block_rows"]
        self.rating = t["interact_rating"]
        self.limits = cell.settings["limits"]
        self.theta, self.p = synth.ensemble(self.s, self.g, self.k, self.r,
                                            synth.torch_generator(device, seed, synth.STATES),
                                            device)
        pool_gen = synth.torch_generator(device, seed, synth.POOL)
        self.pool = [synth.distinct_triplets(self.n, self.g, pool_gen, device).cpu().numpy()
                     for _ in range(t["pool_calls"])]
        self.kept = synth.Reservoir(cell.settings["check_items"], synth.rng(seed, synth.SAMPLE))
        flops = roofline.score_flops(self.n, self.k, self.s)
        self.flops_call = flops
        self.bound_call_s = 1e-3 * roofline.bound(
            flops, roofline.score_bytes(self.n, self.g, self.k, self.s))[0]
        self.blocks = -(-self.n // self.block)
        self._serve = scoring.serve_predict_interaction
        self.states = ModelState(theta=self.theta, p=self.p)
        self.route = "control" if control else scoring.serve_route(
            device.type, True, 3, self.k)
        if not control:
            self._serve(self.states, self.pool[0], self.rating, self.block)  # warm-up
            print(f"screen route: {self.route} (K={self.k}, S={self.s}, {self.n} rows a call)",
                  file=sys.stderr, flush=True)
            launches.check_route(cell, self.route)

    def item(self, i: int) -> dict:
        rows = self.pool[i % len(self.pool)]
        t0 = time.perf_counter()
        if self.control:
            trip = torch.as_tensor(rows, device=self.device)
            out = reference.ensemble_scores(self.theta, self.p, trip, self.rating, "tf32")
            out = out.cpu().numpy()
        else:
            before = launches.launch_counts(self.route)
            with record_function("bench.serve_predict_interaction"):
                out = self._serve(self.states, rows, self.rating, self.block)
            launches.check_launches(self.route, before, self.blocks)
        host = time.perf_counter() - t0
        self.kept.offer(i, out)
        return {"route": self.route, "host_s": host, "rows": self.n,
                "flops": self.flops_call, "bound_s": self.bound_call_s}

    def close(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """name -> (worst reading over the sampled calls, limit)."""
        worst = 0.0
        for i, out in self.kept.items:
            trip = torch.as_tensor(self.pool[i % len(self.pool)], device=self.device)
            want = reference.ensemble_scores(self.theta, self.p, trip, self.rating, "float64")
            got = torch.as_tensor(out, device=self.device).double()
            gap = float((got - want).abs().max()) if got.shape == want.shape else math.inf
            worst = max(worst, gap if math.isfinite(gap) else math.inf)
        return {"score_gap": (worst, float(self.limits["score_gap"]))}
