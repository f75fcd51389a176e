"""Checkpoint / resume and text dumps (counterpart of the reference's
``train/checkpoint.py``, whose module pulls in jax through its imports).

The ``.npz`` format is the reference's, key for key -- ``theta, p, sweep,
ll_trace, key, config_json`` and ``extra_*`` -- so a checkpoint written by
either package loads in the other.  Writes are atomic (tmp + rename).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import to_numpy as _host


def save_checkpoint(
    path: str,
    states: ModelState,
    sweep: int,
    ll_trace: np.ndarray,
    key: Optional[np.ndarray] = None,
    config_json: Optional[str] = None,
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """``states`` may hold tensors (any device) or arrays; ``extra`` arrays
    are stored under ``extra_``-prefixed keys."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    np.savez(
        tmp,
        theta=_host(states.theta),
        p=_host(states.p),
        sweep=np.int64(sweep),
        ll_trace=np.asarray(ll_trace, dtype=np.float64),
        key=np.asarray(key) if key is not None else np.zeros(0, dtype=np.uint32),
        config_json=np.bytes_((config_json or "").encode()),
        **{f"extra_{k}": _host(v) for k, v in (extra or {}).items()},
    )
    # np.savez appends .npz to the filename it opens.
    os.replace(tmp + ".npz", path)


def load_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    """The reference's dict layout; ``states`` is a ModelState of float32
    tensors on ``device``."""
    with np.load(path, allow_pickle=False) as z:
        cfg = bytes(z["config_json"]).decode() or None
        return {
            "states": ModelState(
                theta=torch.as_tensor(z["theta"], device=device),
                p=torch.as_tensor(z["p"], device=device),
            ),
            "sweep": int(z["sweep"]),
            "ll_trace": z["ll_trace"],
            "key": z["key"] if z["key"].size else None,
            "config_json": cfg,
            "extra": {
                k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
            },
        }


def write_text_dump(
    out_dir: str, states: ModelState, ll_trace: np.ndarray, gene_names=None
) -> None:
    """Reference-style per-sample text outputs: ``theta_s{S}.txt`` (gene
    name then K memberships), ``p_s{S}.txt`` (group-tuple indices then R
    probabilities) and a shared ``likelihood.txt`` trace."""
    os.makedirs(out_dir, exist_ok=True)
    theta = _host(states.theta)
    p = _host(states.p)
    if theta.ndim == 2:  # single sample -> add the sample axis
        theta, p = theta[None], p[None]
    S, G, K = theta.shape
    for s in range(S):
        with open(os.path.join(out_dir, f"theta_s{s}.txt"), "w") as fh:
            for g in range(G):
                name = gene_names[g] if gene_names else str(g)
                fh.write(name + "\t" + "\t".join(f"{v:.8f}" for v in theta[s, g]) + "\n")
        with open(os.path.join(out_dir, f"p_s{s}.txt"), "w") as fh:
            for cell in np.ndindex(p.shape[1:-1]):
                probs = "\t".join(f"{v:.8f}" for v in p[(s, *cell)])
                idx = "\t".join(str(i) for i in cell)
                fh.write(f"{idx}\t{probs}\n")
    with open(os.path.join(out_dir, "likelihood.txt"), "w") as fh:
        for row in np.atleast_2d(np.asarray(ll_trace, dtype=np.float64)):
            fh.write("\t".join(f"{v:.6f}" for v in np.atleast_1d(row)) + "\n")
