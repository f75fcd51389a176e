"""Traffic kind ``fit_tsv``: the closed loop of whole fits of kind ``fit``
(``benchmark/kinds/fit.py``: the same window, launch checks, records and
float64 comparison), on rows a user's fit reads from a Data S1 TSV.

At set-up the client writes the configuration's screen from the seed
(``benchmark/data_s1.py``) under ``.bench_cache/``, loads it with the
program's ``data/kuzmin.py::load_kuzmin_tsv`` (default ``DataConfig``,
trigenic rows) and splits it with the program's
``data/splits.py::train_test_split``, as ``cli fit -f`` does; both keep
the file's query order.  The run is refused unless the loaded rows and
labels equal the plain reader's row for row (genes by name).  The
comparison's reference gets the same training rows.

It records once, at set-up, the program's census of K1's key sum on the
training rows (``ops/em_bdr.py::key_census``), which the metric
``k1_key_chain`` reads from every fit's record; a program without that
census cannot run the cell.  The set-up line gives the host time of the
loader's spans ``data.parse`` and ``data.pack``.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import data_s1, harness, launches, reference, roofline, synth
from benchmark.kinds import fit

H100_SMS = 132  # the census's SM count where the run has no card (CPU tests)


class Client(fit.Client):
    def __init__(self, cell, seed: int, device: torch.device, control: bool = False):
        from trigenicinteractionpredictor_tpu_torch.config import Config
        from trigenicinteractionpredictor_tpu_torch.data.kuzmin import load_kuzmin_tsv
        from trigenicinteractionpredictor_tpu_torch.data.splits import train_test_split
        from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
        from trigenicinteractionpredictor_tpu_torch.ops import em_bdr
        from trigenicinteractionpredictor_tpu_torch.train import trainer
        from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger

        if not hasattr(em_bdr, "key_census"):
            raise RuntimeError("the program has no ops/em_bdr.py::key_census, "
                               f"which cell {cell.name} records at set-up")
        c, t = cell.config, cell.traffic
        self.seed, self.device, self.control = seed, device, control
        self.k, self.r = c["k"], c["n_ratings"]
        self.s, self.sweeps, self.freq = t["samples"], t["sweeps"], c["likelihood_freq"]
        self.limits = cell.settings["limits"]

        cache = os.path.join(cell.root, harness.CACHE_DIR)
        os.makedirs(cache, exist_ok=True)
        path = os.path.join(cache, f"{cell.name}.{os.getpid()}.tsv")
        try:
            written = data_s1.write_tsv(path, c, seed)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                ds = load_kuzmin_tsv(path)
            want_names, want_labels = data_s1.read_rows(path, c["p_cutoff"], c["tau_cutoff"])
        finally:
            if os.path.exists(path):
                os.remove(path)
        span_ms = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
                   if e.key in ("data.parse", "data.pack")}
        got_names = np.asarray(ds.gene_names, dtype=str)[ds.triplets]
        if not (got_names.shape == want_names.shape and np.array_equal(got_names, want_names)
                and np.array_equal(ds.ratings, want_labels)):
            raise RuntimeError(f"the loader's {ds.n_rows} rows differ from the plain reader's "
                               f"{want_labels.size}: genes or labels")
        if ds.n_rows != c["n_triplets"] or ds.n_genes != c["n_genes"]:
            raise RuntimeError(f"loaded {ds.n_rows} rows of {ds.n_genes} genes; the "
                               f"configuration has {c['n_triplets']} of {c['n_genes']}")
        split_seed = int(synth.rng(seed, data_s1.ROWS, 1).integers(0, 2**63))
        self.ds, _ = train_test_split(ds, c["test_fraction"], seed=split_seed)
        self.rows = synth.Rows(self.ds.triplets, self.ds.ratings)
        self.g, self.n = ds.n_genes, self.ds.n_rows
        n_sm = em_bdr.sm_count(device) if device.type == "cuda" else H100_SMS
        self.census = em_bdr.key_census(self.ds.triplets, self.ds.weights, self.s, self.k,
                                        self.r, n_sm)
        print(f"Data S1: {written.lines} lines, {ds.n_rows} trigenic rows of {ds.n_genes} "
              f"genes, {ds.ratings.mean():.4f} positive, {self.n} train rows; spans (host ms) "
              f"data.parse {span_ms.get('data.parse', float('nan')):.1f}, data.pack "
              f"{span_ms.get('data.pack', float('nan')):.1f}; K1 key census ({n_sm} SMs): "
              f"{self.census.tiles} tiles a restart, {self.census.keys:.2f} keys a tile, "
              f"chain {self.census.chain:.2f} a tile (max {self.census.chain_max})",
              file=sys.stderr, flush=True)

        base = Config()
        self.cfg = base.replace(train=dataclasses.replace(
            base.train, k=self.k, sweeps=self.sweeps, samples=self.s,
            likelihood_freq=self.freq, tol=c["tol"]))
        self._fit, self._state = trainer.fit, ModelState
        self.log = JsonlLogger(None, echo=False)
        self.kept = synth.Reservoir(cell.settings["check_items"], synth.rng(seed, synth.SAMPLE))
        self.flops_sweep = roofline.sweep_flops(self.n, self.k, self.s)
        self.bound_sweep_s = 1e-3 * roofline.bound(
            self.flops_sweep, roofline.sweep_bytes(self.n, self.g, self.k, self.r, self.s))[0]
        self.ref_rows = None
        if control:
            self.ref_rows = reference.device_rows(self.rows.triplets, self.rows.ratings,
                                                  self.g, self.r, device)
            self.route = "control"
            return
        warm = self.cfg.replace(train=dataclasses.replace(self.cfg.train, sweeps=self.freq))
        res = self._fit(warm, self.ds, device=device, logger=self.log,
                        init_states=self._init(-1))
        self.route = res.dispatch["kernel"]
        print(f"fit route: {self.route} (K={self.k}, S={self.s}, {self.n} train rows)",
              file=sys.stderr, flush=True)
        launches.check_route(cell, self.route)

    def _record(self, host: float, prog: float, sweeps: int) -> dict:
        return dict(super()._record(host, prog, sweeps), key_chain=self.census.chain)
