"""Traffic kind ``fit``: a closed loop of whole EM fits through the port's
``train.trainer.fit``, one after another on the configuration's training
split.

Traffic parameters: ``samples`` (restarts S a fit) and ``sweeps`` (a fit's
EM sweeps; the configuration's ``tol`` 0 never stops early, so every fit
does the same work).  Each fit starts from a fresh ensemble drawn from the
seed on the device and handed over as ``fit(..., init_states=...)``.

The warm-up fit's route has to be the one the cell names, else the run is
refused.  Per fit the client records the benchmark's host time around
``fit()``, the program's own ``FitResult.wall_seconds``, the route and the
work, and checks that each kernel of the route launched once a sweep.  The
comparison runs the plain reference (float64) from the same initial
states over the same rows for a sample of the window's fits drawn from
the seed, and compares the L trace and final L (relative gap), and the
final theta and p (absolute gap).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import launches, reference, roofline, synth


class Client:
    def __init__(self, cell, seed: int, device: torch.device, control: bool = False):
        from trigenicinteractionpredictor_tpu_torch.config import Config
        from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset
        from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
        from trigenicinteractionpredictor_tpu_torch.train import trainer
        from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger

        c, t = cell.config, cell.traffic
        self.seed, self.device, self.control = seed, device, control
        self.g, self.k, self.r = c["n_genes"], c["k"], c["n_ratings"]
        self.s, self.sweeps, self.freq = t["samples"], t["sweeps"], c["likelihood_freq"]
        self.limits = cell.settings["limits"]
        planted = synth.planted_rows(c["n_triplets"], self.g, self.k, self.r,
                                     c["planted"]["alpha_theta"], c["planted"]["alpha_p"], seed)
        self.rows = synth.train_rows(planted, c["test_fraction"], seed)
        n = self.rows.triplets.shape[0]
        self.n = n
        self.ds = TripletDataset(self.rows.triplets, self.rows.ratings,
                                 np.ones(n, np.float32), self.g, self.r)
        base = Config()
        self.cfg = base.replace(train=dataclasses.replace(
            base.train, k=self.k, sweeps=self.sweeps, samples=self.s,
            likelihood_freq=self.freq, tol=c["tol"]))
        self._fit, self._state = trainer.fit, ModelState
        self.log = JsonlLogger(None, echo=False)
        self.kept = synth.Reservoir(cell.settings["check_items"], synth.rng(seed, synth.SAMPLE))
        flops = roofline.sweep_flops(n, self.k, self.s)
        self.flops_sweep = flops
        self.bound_sweep_s = 1e-3 * roofline.bound(
            flops, roofline.sweep_bytes(n, self.g, self.k, self.r, self.s))[0]
        self.ref_rows = None
        if control:
            self.ref_rows = reference.device_rows(self.rows.triplets, self.rows.ratings,
                                                  self.g, self.r, device)
            self.route = "control"
            return
        # Warm-up: one fit of one L check's sweeps builds the kernels, runs
        # the integrity sentinel and touches every shape a fit uses.
        warm = self.cfg.replace(train=dataclasses.replace(self.cfg.train, sweeps=self.freq))
        res = self._fit(warm, self.ds, device=device, logger=self.log,
                        init_states=self._init(-1))
        self.route = res.dispatch["kernel"]
        print(f"fit route: {self.route} (K={self.k}, S={self.s}, {n} train rows)",
              file=sys.stderr, flush=True)
        launches.check_route(cell, self.route)

    def _init(self, i: int):
        gen = synth.torch_generator(self.device, self.seed, synth.INIT, i + 1)
        return self._state(*synth.ensemble(self.s, self.g, self.k, self.r, gen, self.device))

    def item(self, i: int) -> dict:
        with record_function("bench.init_draw"):
            init = self._init(i)
        if self.control:
            t0 = time.perf_counter()
            out = reference.fit(init.theta, init.p, self.ref_rows, self.sweeps, self.freq, "tf32")
            host = time.perf_counter() - t0
            self.kept.offer(i, (out.theta, out.p, out.ll_trace.cpu().numpy(),
                                out.final_ll.cpu().numpy()))
            return self._record(host, host, self.sweeps)
        before = launches.launch_counts(self.route)
        t0 = time.perf_counter()
        with record_function("bench.fit"):
            res = self._fit(self.cfg, self.ds, device=self.device, logger=self.log,
                            init_states=init)
        host = time.perf_counter() - t0
        if res.dispatch["kernel"] != self.route:
            raise RuntimeError(f"fit {i} ran route {res.dispatch['kernel']}, "
                               f"the warm-up ran {self.route}")
        launches.check_launches(self.route, before, res.sweeps_run)
        self.kept.offer(i, (res.states.theta, res.states.p, res.ll_trace, res.final_loglik))
        return self._record(host, res.wall_seconds, res.sweeps_run)

    def _record(self, host: float, prog: float, sweeps: int) -> dict:
        return {"route": self.route, "host_s": host, "prog_s": prog, "sweeps": sweeps,
                "updates": sweeps * self.n * self.s, "flops": sweeps * self.flops_sweep,
                "bound_s": sweeps * self.bound_sweep_s}

    def close(self) -> None:
        del self.ds
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """name -> (worst reading over the sampled fits, limit)."""
        rows = self.ref_rows
        if rows is None:
            rows = reference.device_rows(self.rows.triplets, self.rows.ratings, self.g,
                                         self.r, self.device)
        worst = {"ll_gap": 0.0, "theta_gap": 0.0, "p_gap": 0.0}
        for i, (theta, p, trace, final) in self.kept.items:
            init = self._init(i)
            ref = reference.fit(init.theta, init.p, rows, self.sweeps, self.freq, "float64")
            got = np.vstack([np.asarray(trace, np.float64), np.asarray(final, np.float64)[None]])
            want = torch.cat([ref.ll_trace, ref.final_ll[None]]).cpu().numpy()
            if got.shape != want.shape:
                raise RuntimeError(f"fit {i}: L trace {got.shape}, reference {want.shape}")
            gaps = {"ll_gap": float(np.max(np.abs(got - want) / np.abs(want))),
                    "theta_gap": float((theta.double() - ref.theta).abs().max()),
                    "p_gap": float((p.double() - ref.p).abs().max())}
            for name, gap in gaps.items():
                worst[name] = max(worst[name], gap if math.isfinite(gap) else math.inf)
        return {name: (value, float(self.limits[name])) for name, value in worst.items()}
