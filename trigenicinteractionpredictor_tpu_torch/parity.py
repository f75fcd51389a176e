"""Parity-readiness gate against the upstream reference (the port's copy of
the reference's ``parity.py``, run on the port's loader, ``fit``,
``evaluate``, ``serve_predict_interaction`` and ``write_text_dump``).

1. :func:`reference_mount_status` -- what, if anything, a directory that
   should hold the upstream reference tree holds.  The directory is the
   caller's (``verify-parity --reference-mount DIR``); the port names no
   default path.
2. :func:`loader_fingerprint` -- the loader-semantics fingerprint of a TSV:
   raw row counts by mutant type, extracted row / gene counts, positive
   labels under every cutoff mode, and the deduplication delta.  Loader
   semantics are the first place a silent mismatch hides; diff these
   counts against the reference loader's before comparing any model
   quantity.
3. :func:`parity_artifact` -- a reference-comparable converged artifact:
   best-restart train / held-out log-likelihood, held-out AUC / AP, and the
   first predicted interaction probabilities, with the config and dataset
   digests, in one JSON.

docs/PARITY.md describes the comparison procedure.
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
from collections import Counter
from dataclasses import replace
from typing import Dict, Optional

import numpy as np

from trigenicinteractionpredictor_tpu_torch.config import Config, DataConfig
from trigenicinteractionpredictor_tpu_torch.data.kuzmin import (
    _ARRAY_COLS,
    _PVAL_COLS,
    _QUERY_COLS,
    _TAU_COLS,
    _TYPE_COLS,
    _find_col,
    _norm_col,
    load_kuzmin_tsv,
)


def reference_mount_status(path: Optional[str]) -> Dict:
    """What the reference mount ``path`` holds (None: no mount was given)."""
    if path is None or not os.path.isdir(path):
        return {"path": path, "present": False, "n_files": 0, "files": [],
                **({"note": "no reference mount given"} if path is None else {})}
    files = sorted(
        os.path.relpath(os.path.join(root, n), path)
        for root, _dirs, names in os.walk(path) for n in names
    )
    return {
        "path": path,
        "present": True,
        "n_files": len(files),
        "files": files[:200],
        "note": (
            "mount is EMPTY -- the reconstructed spec remains authoritative"
            if not files else
            "REFERENCE PRESENT: re-verify the spec's recalled claims against "
            "this tree before trusting parity numbers"
        ),
    }


def loader_fingerprint(path: str, cfg: Optional[DataConfig] = None) -> Dict:
    """Loader-semantics fingerprint of a Kuzmin-style TSV.

    Counts raw rows by mutant type straight off the file, then loads the
    dataset under every label-cutoff mode and reports extracted row / gene /
    positive counts and the dedup delta.  All counts are exact integers.
    """
    cfg = cfg or DataConfig()
    type_counts: Counter = Counter()
    n_raw = 0
    with open(path, "r", newline="") as fh:
        reader = csv.reader(fh, delimiter="\t")
        header = next(reader)
        ti = _find_col(header, _TYPE_COLS)
        for rec in reader:
            n_raw += 1
            if ti is not None and len(rec) > ti:
                type_counts[_norm_col(rec[ti])] += 1
    fp: Dict = {
        "file": os.path.basename(path),
        "sha256_first_mb": _digest_file(path),
        "n_raw_rows": n_raw,
        "rows_by_mutant_type": dict(sorted(type_counts.items())),
        "columns_resolved": {
            "query": _find_col(header, _QUERY_COLS),
            "array": _find_col(header, _ARRAY_COLS),
            "type": ti,
            "tau": _find_col(header, _TAU_COLS),
            "p_value": _find_col(header, _PVAL_COLS),
        },
        "modes": {},
    }
    for mutant_type in ("trigenic", "digenic"):
        for tau_mode in ("abs", "negative"):
            mcfg = replace(cfg, mutant_type=mutant_type, tau_mode=tau_mode)
            ds = load_kuzmin_tsv(path, mcfg)
            dedup = load_kuzmin_tsv(path, replace(mcfg, deduplicate=True))
            fp["modes"][f"{mutant_type}/{tau_mode}"] = {
                "rows": int(ds.n_real),
                "genes": int(ds.n_genes),
                "positives": int(np.sum(ds.ratings[ds.weights > 0] == 1)),
                "dedup_rows": int(dedup.n_real),
                "dedup_delta": int(ds.n_real - dedup.n_real),
                "p_cutoff": mcfg.p_cutoff,
                "tau_cutoff": mcfg.tau_cutoff,
            }
    return fp


def _digest_file(path: str, n_bytes: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        h.update(fh.read(n_bytes))
    return h.hexdigest()[:16]


def _digest_array(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def parity_artifact(path: str, cfg: Config, out_dir: str, device="cuda") -> Dict:
    """Train on the configured split on ``device`` and write a
    reference-comparable artifact: converged train and held-out
    log-likelihood (best restart), held-out AUC (sample-averaged), the
    head of the served interaction probabilities, the full Config and
    dataset digests; plus the text dumps and every test row's score."""
    from trigenicinteractionpredictor_tpu_torch.data.splits import train_test_split
    from trigenicinteractionpredictor_tpu_torch.eval import evaluate
    from trigenicinteractionpredictor_tpu_torch.ops.scoring import serve_predict_interaction
    from trigenicinteractionpredictor_tpu_torch.train.checkpoint import write_text_dump
    from trigenicinteractionpredictor_tpu_torch.train.trainer import fit

    os.makedirs(out_dir, exist_ok=True)
    ds = load_kuzmin_tsv(path, cfg.data)
    train, test = train_test_split(ds, cfg.split.test_fraction, cfg.split.seed)
    result = fit(cfg, train, device=device)

    report = evaluate(result.states, test, result.final_loglik)
    scores = serve_predict_interaction(result.states, test.triplets)
    best = int(np.argmax(result.final_loglik))
    names = ds.gene_names or [str(i) for i in range(ds.n_genes)]
    head = [
        {
            "genes": [names[g] for g in test.triplets[i]],
            "label": int(test.ratings[i]),
            "p_interact": round(float(scores[i]), 6),
        }
        for i in range(min(20, len(scores)))
    ]
    artifact = {
        "config": cfg.to_dict(),
        "dataset": {
            "file": os.path.basename(path),
            "rows": int(ds.n_real),
            "genes": int(ds.n_genes),
            "triplets_digest": _digest_array(ds.triplets),
            "ratings_digest": _digest_array(ds.ratings),
            "train_rows": int(train.n_real),
            "test_rows": int(test.n_real),
        },
        "converged": {
            "train_loglik_best": float(result.final_loglik.max()),
            "train_loglik_per_restart": [round(float(x), 3) for x in result.final_loglik],
            "best_restart": best,
            "sweeps_run": int(result.sweeps_run),
            **report.to_dict(),
        },
        "predictions_head": head,
    }
    with open(os.path.join(out_dir, "parity_artifact.json"), "w") as fh:
        json.dump(artifact, fh, indent=2)
    write_text_dump(os.path.join(out_dir, "params"), result.states, result.ll_trace,
                    gene_names=ds.gene_names)
    np.savetxt(
        os.path.join(out_dir, "test_scores.tsv"),
        np.column_stack([test.triplets, test.ratings, scores]),
        fmt=["%d"] * (test.arity + 1) + ["%.6f"],
        delimiter="\t",
        header="\t".join(["gene_a", "gene_b", "gene_c"][: test.arity]
                         + ["label", "p_interaction"]),
        comments="",
    )
    return artifact


def run_verify_parity(path: str, cfg: Config, out_dir: str, do_fit: bool = True,
                      device="cuda", reference_mount: Optional[str] = None) -> Dict:
    """The full gate: mount status + fingerprint (+ converged artifact),
    written to ``out_dir/verify_parity.json``."""
    report = {
        "reference_mount": reference_mount_status(reference_mount),
        "loader_fingerprint": loader_fingerprint(path, cfg.data),
    }
    if do_fit:
        report["artifact"] = parity_artifact(path, cfg, out_dir, device=device)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "verify_parity.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    return report
