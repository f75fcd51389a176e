"""Experiment driver: the fold x K grid as idempotent work units
(counterpart of the reference's ``train/driver.py``).

Each (fold, K) pair is a *work unit*: one restart-stacked ``fit`` of the
unit's training split, then ``evaluate`` on its held-out split.  A finished
unit writes ``<out>/units/<unit>.json``, its DONE marker; a re-launched
driver skips finished units and resumes an interrupted one from
``<out>/units/<unit>.ckpt.npz``.  :func:`merge_report` selects the best K
per fold by held-out likelihood and writes ``<out>/report.json``.  Unit
names, marker JSON, event files and the report are the reference's, so
either package can merge the other's units.

Across processes (the reference's ``run_units``): units go round-robin by
rank, and each unit's fit runs on this process's own device (a local
mesh), since ranks running different units cannot share collectives.  A
caller that wants every unit spread over all ranks passes a mesh that
spans them; then every rank runs every unit and the mesh's origin alone
writes the markers.  Each rank logs to ``<out>/events_p{rank}.jsonl``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from trigenicinteractionpredictor_tpu_torch.config import Config
from trigenicinteractionpredictor_tpu_torch.data import (
    TripletDataset,
    kfold_splits,
    train_test_split,
)
from trigenicinteractionpredictor_tpu_torch.eval import evaluate
from trigenicinteractionpredictor_tpu_torch.parallel.distributed import topology
from trigenicinteractionpredictor_tpu_torch.parallel.mesh import Mesh, single_device_mesh
from trigenicinteractionpredictor_tpu_torch.train.trainer import fit
from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger


@dataclass
class WorkUnit:
    fold: int
    k: int
    train_ds: TripletDataset
    test_ds: TripletDataset

    @property
    def name(self) -> str:
        return f"fold{self.fold}_k{self.k}"


def make_work_units(cfg: Config, ds: TripletDataset, k_grid: Sequence[int]) -> List[WorkUnit]:
    """Every (fold, K) unit: one seeded 80/20 split when ``cfg.split.n_folds``
    <= 1, else seeded k-fold CV; K varies fastest."""
    if cfg.split.n_folds <= 1:
        tr, te = train_test_split(ds, cfg.split.test_fraction, cfg.split.seed)
        folds: Iterable[Tuple[int, TripletDataset, TripletDataset]] = [(0, tr, te)]
    else:
        folds = kfold_splits(ds, cfg.split.n_folds, cfg.split.seed)
    return [
        WorkUnit(fold=fold, k=k, train_ds=tr, test_ds=te)
        for fold, tr, te in folds
        for k in k_grid
    ]


def run_units(
    cfg: Config,
    ds: TripletDataset,
    k_grid: Optional[Sequence[int]] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    device="cuda",
    stats_fn=None,
    mesh: Optional[Mesh] = None,
) -> List[dict]:
    """Run this process's share of the fold x K grid on ``device``; return
    its unit records (a finished unit's record is read back from its DONE
    marker).  ``process_index`` / ``process_count`` default to the rank and
    the world size (see the module docstring for ``mesh``)."""
    topo = topology()
    rank = topo.process_index if process_index is None else process_index
    pi, pc = rank, topo.process_count if process_count is None else process_count
    writer = True
    if mesh is not None and mesh.size > 1:
        pi, pc, writer = 0, 1, mesh.is_coordinator  # every rank runs every unit
    elif mesh is None and topo.process_count > 1:
        # One process drives one device: the local mesh keeps cfg.mesh's
        # ensemble and model axes only if they fit on it (the reference's
        # driver.py:84-106 and its refusal).
        local = 1
        e, m = max(cfg.mesh.ensemble, 1), max(cfg.mesh.model, 1)
        if local % (e * m) != 0:
            raise ValueError(
                f"{local} local devices do not divide by mesh.ensemble*mesh.model="
                f"{e * m}; fix --mesh-ensemble/--mesh-model or pass an explicit mesh"
            )
        mesh = single_device_mesh()
    k_grid = list(k_grid or [cfg.train.k])
    units_dir = os.path.join(cfg.out_dir, "units")
    os.makedirs(units_dir, exist_ok=True)
    records: List[dict] = []
    with JsonlLogger(os.path.join(cfg.out_dir, f"events_p{rank}.jsonl")) as logger:
        if mesh is not None:
            logger.log("local_mesh", **mesh.shape)
        for i, unit in enumerate(make_work_units(cfg, ds, k_grid)):
            if i % pc != pi:
                continue
            done_path = os.path.join(units_dir, f"{unit.name}.json")
            if os.path.exists(done_path):
                with open(done_path) as fh:
                    records.append(json.load(fh))
                logger.log("unit_skipped_done", unit=unit.name)
                continue
            ckpt = os.path.join(units_dir, f"{unit.name}.ckpt.npz")
            resume = ckpt if os.path.exists(ckpt) else None
            ucfg = cfg.replace(train=dataclasses.replace(cfg.train, k=unit.k))
            logger.log("unit_start", unit=unit.name, resume=bool(resume))
            result = fit(
                ucfg, unit.train_ds, device=device, logger=logger, resume=resume,
                checkpoint_path=ckpt, stats_fn=stats_fn, mesh=mesh,
            )
            report = evaluate(result.states, unit.test_ds, result.final_loglik)
            rec = {
                "unit": unit.name,
                "fold": unit.fold,
                "k": unit.k,
                "process": rank,
                "sweeps": result.sweeps_run,
                "triplets_per_sec": result.triplets_per_sec,
                "ll_best": float(result.final_loglik.max()),
                "ll_per_sample": [float(x) for x in result.final_loglik],
                **report.to_dict(),
                "dispatch": result.dispatch,
            }
            if writer:
                with open(done_path + ".tmp", "w") as fh:
                    json.dump(rec, fh, indent=2)
                os.replace(done_path + ".tmp", done_path)  # DONE marker, atomic
            logger.log("unit_done", unit=unit.name, auc=report.auc)
            records.append(rec)
    return records


def merge_report(out_dir: str) -> dict:
    """Merge every finished unit into ``<out_dir>/report.json``.  The best
    K per fold is the unit with the highest held-out likelihood of its best
    restart (training likelihood grows with K and would always pick the
    largest); marker JSON without ``heldout_loglik`` falls back to the
    training likelihood, as the reference does."""
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "units", "*.json"))):
        with open(path) as fh:
            recs.append(json.load(fh))
    if not recs:
        return {"units": [], "summary": {}}
    by_fold: dict = {}
    for r in recs:
        by_fold.setdefault(r["fold"], []).append(r)
    best_per_fold = {
        f: max(rs, key=lambda r: r.get("heldout_loglik", r["ll_best"]))
        for f, rs in by_fold.items()
    }
    selected = list(best_per_fold.values())
    summary = {
        "mean_auc_selected": float(np.mean([r["auc"] for r in selected])),
        "mean_ap_selected": float(np.mean([r["average_precision"] for r in selected])),
        "mean_auc": float(np.mean([r["auc"] for r in recs])),
        "mean_ap": float(np.mean([r["average_precision"] for r in recs])),
        "best_k_per_fold": {str(f): r["k"] for f, r in best_per_fold.items()},
        "best_auc_per_fold": {str(f): r["auc"] for f, r in best_per_fold.items()},
        "n_units": len(recs),
    }
    report = {"units": recs, "summary": summary}
    with open(os.path.join(out_dir, "report.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    return report
