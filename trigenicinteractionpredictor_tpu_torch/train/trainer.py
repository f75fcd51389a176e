"""The classic full-batch EM fit loop on one device (counterpart of the
classic branch of the reference's ``train/trainer.py::fit``).

All S restarts ride a leading axis of one state; each sweep is one call of
the dispatched stats function (K1 or K3 on CUDA; the plain sweep, chunked
by ``cfg.engine.jnp_row_chunk`` rows, elsewhere) plus
``normalize_from_stats``.
The host loop runs the sweeps between likelihood checks, records every
``likelihood_freq`` sweeps the L of the state *before* the chunk's last
sweep (the reference's semantics), early-stops on |dL| < tol one check
late (the trace is read after the next chunk is queued, so the read
overlaps device work), and checkpoints.

Not carried by this slice, and refused with ``NotImplementedError``:
stepwise EM (``minibatch > 0``), annealing, refine and split-merge rounds,
the spectral init, and any mesh axis above 1.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from trigenicinteractionpredictor_tpu.config import Config
from trigenicinteractionpredictor_tpu.data.packing import TripletDataset
from trigenicinteractionpredictor_tpu.utils.logging import JsonlLogger, get_logger
from trigenicinteractionpredictor_tpu_torch.device import resolve_device
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import (
    ModelState,
    init_state,
    state_from_numpy,
)
from trigenicinteractionpredictor_tpu_torch.ops import _build
from trigenicinteractionpredictor_tpu_torch.ops.dispatch import resolve_stats_fn
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    log_likelihood,
    make_batch,
    normalize_from_stats,
)
from trigenicinteractionpredictor_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)


@dataclass
class FitResult:
    """Converged ensemble of one fit."""

    states: ModelState            # restart-stacked [S, ...] on the fit's device
    final_loglik: np.ndarray      # f64 [S] -- L of the final states
    ll_trace: np.ndarray          # f64 [n_checks, S]
    sweeps_run: int
    triplets_per_sec: float
    wall_seconds: float
    dispatch: dict = field(default_factory=dict)


def _dispatch_extra(dispatch_info: dict) -> dict:
    """Checkpoint ``extra`` entry carrying the dispatch decision (JSON as a
    uint8 array, as the reference stores it)."""
    return {
        "dispatch_json": np.frombuffer(
            json.dumps(dispatch_info, sort_keys=True).encode(), dtype=np.uint8
        )
    }


def _check_scope(cfg: Config) -> None:
    tcfg = cfg.train
    missing = []
    if tcfg.minibatch > 0:
        missing.append(f"minibatch={tcfg.minibatch} (stepwise EM)")
    if tcfg.anneal_beta0 < 1.0:
        missing.append(f"anneal_beta0={tcfg.anneal_beta0} (annealing)")
    if tcfg.refine_rounds > 0:
        missing.append(f"refine_rounds={tcfg.refine_rounds}")
    if tcfg.smem_rounds > 0:
        missing.append(f"smem_rounds={tcfg.smem_rounds}")
    if tcfg.init_method != "random":
        missing.append(f"init_method={tcfg.init_method!r}")
    for axis in ("data", "ensemble", "model"):
        if getattr(cfg.mesh, axis) > 1:
            missing.append(f"mesh.{axis}={getattr(cfg.mesh, axis)} (one device only)")
    if missing:
        raise NotImplementedError(
            "not ported to the PyTorch engine yet: " + ", ".join(missing)
            + "; the JAX package (trigenicinteractionpredictor_tpu) runs them"
        )


def fit(
    cfg: Config,
    train_ds: TripletDataset,
    device="cuda",
    logger: Optional[JsonlLogger] = None,
    resume: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    stats_fn=None,
    init_states: Optional[ModelState] = None,
) -> FitResult:
    """Fit ``cfg.train.samples`` restarts of the MMSBM on a training split.

    ``resume`` -- checkpoint to continue from (same shapes).
    ``stats_fn`` -- override the dispatched sweep-stats function.
    ``init_states`` -- restart-stacked [S, ...] initial states (tensors or
    arrays, e.g. the JAX package's) instead of the seeded random init.
    """
    _check_scope(cfg)
    log = logger or get_logger()
    tcfg = cfg.train
    dev = resolve_device(device)
    if cfg.engine.precision not in ("fast", "strict"):
        raise ValueError(
            f"unknown engine precision {cfg.engine.precision!r}; use 'fast' or 'strict'"
        )
    S, K = tcfg.samples, tcfg.k
    G, R, arity = train_ds.n_genes, train_ds.n_ratings, train_ds.arity
    real = train_ds.weights > 0
    if real.any() and (
        train_ds.triplets[real].min() < 0 or train_ds.triplets[real].max() >= G
        or train_ds.ratings[real].min() < 0 or train_ds.ratings[real].max() >= R
    ):
        raise ValueError(f"gene ids must lie in [0, {G}) and ratings in [0, {R})")

    if stats_fn is None:
        stats_fn = resolve_stats_fn(
            dev, arity, G, K, S, n_ratings=R, row_chunk=cfg.engine.jnp_row_chunk
        )
    # Both engine precision modes run exact float32 here: the kernels use
    # no tensor cores and the plain path runs with TF32 off.
    dispatch_info = {
        "kernel": getattr(stats_fn, "kernel_name", None)
        or getattr(stats_fn, "__name__", type(stats_fn).__name__),
        "tile_b": 0,
        "bdr_group": 0,
        "row_chunk": int(getattr(stats_fn, "row_chunk", 0)),
        "precision": cfg.engine.precision,
        "backend": cfg.engine.backend,
        "device": str(dev),
    }
    log.log("dispatch", **dispatch_info)
    if dev.type == "cuda":
        # Build (or load) the CUDA kernels now, so set-up stays out of the
        # fit's wall clock.
        _build.library()
        log.log("kernels_built", seconds=_build.build_info["seconds"],
                cached=_build.build_info["cached"])

    start_sweep = 0
    ll_rows: List[np.ndarray] = []
    if init_states is not None:
        states = state_from_numpy(init_states.theta, init_states.p, dev)
    elif resume is not None:
        ck = load_checkpoint(resume, dev)
        states = ck["states"]
        start_sweep = ck["sweep"]
        if ck["ll_trace"].size:
            ll_rows = list(np.atleast_2d(ck["ll_trace"]))
        log.log("resume", path=resume, sweep=start_sweep)
    else:
        states = init_state(
            G, K, R, alpha=tcfg.init_alpha, arity=arity, samples=S,
            seed=tcfg.seed, device=dev,
        )
    want = (S, G, K)
    if tuple(states.theta.shape) != want or states.arity != arity:
        raise ValueError(
            f"initial states {tuple(states.theta.shape)} / arity {states.arity} "
            f"do not match samples, genes, k = {want} / arity {arity}"
        )

    batch = make_batch(train_ds.triplets, train_ds.ratings, train_ds.weights, dev)
    degrees = torch.as_tensor(train_ds.degrees(), device=dev)
    n_real = train_ds.n_real
    config_json = cfg.to_json()
    # Provenance of the init: the seed in the reference's key-data layout.
    key_data = np.asarray([(tcfg.seed >> 32) & 0xFFFFFFFF, tcfg.seed & 0xFFFFFFFF],
                          dtype=np.uint32)
    freq = max(tcfg.likelihood_freq, 1)
    ce = tcfg.checkpoint_every if checkpoint_path else 0

    def next_boundary(s: int) -> int:
        b = min(tcfg.sweeps, (s // freq + 1) * freq)
        if ce > 0:
            b = min(b, (s // ce + 1) * ce)
        return b

    def checkpoint(at_sweep: int) -> None:
        save_checkpoint(
            checkpoint_path, states, at_sweep,
            np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
            key=key_data, config_json=config_json,
            extra=_dispatch_extra(dispatch_info),
        )

    prev_check: Optional[np.ndarray] = None
    pending: Optional[Tuple[int, torch.Tensor]] = None
    t0 = time.perf_counter()

    def flush_pending() -> bool:
        nonlocal prev_check, pending
        if pending is None:
            return False
        at_sweep, ll = pending
        pending = None
        ll_np = ll.cpu().numpy().astype(np.float64)  # L of the pre-update state
        ll_rows.append(ll_np)
        dt = time.perf_counter() - t0
        log.log(
            "sweep",
            sweep=at_sweep,
            ll_best=float(ll_np.max()),
            ll_mean=float(ll_np.mean()),
            triplets_per_sec=(at_sweep - start_sweep) * n_real / max(dt, 1e-9),
        )
        halt = False
        # The reference's annealing guard reduces to this with no ramp: no
        # early stop before the check at 2 * freq.
        if tcfg.tol > 0 and prev_check is not None and at_sweep >= 2 * freq:
            if np.all(np.abs(ll_np - prev_check) < tcfg.tol):
                halt = True
                log.log("early_stop", sweep=at_sweep, tol=tcfg.tol)
        prev_check = ll_np
        return halt

    sweep = start_sweep
    stop = False
    while sweep < tcfg.sweeps and not stop:
        n_inner = next_boundary(sweep) - sweep
        for _ in range(n_inner):
            stats = stats_fn(states.theta, states.p, batch)
            states = normalize_from_stats(states, stats, degrees)
        if tcfg.debug_nans and not (
            torch.isfinite(states.theta).all() and torch.isfinite(states.p).all()
        ):
            raise FloatingPointError(f"non-finite parameters after sweep {sweep + n_inner}")
        sweep += n_inner
        stop = flush_pending()  # the previous check syncs while this chunk runs
        if sweep % freq == 0 or sweep == tcfg.sweeps:
            pending = (sweep, stats.loglik)
        if ce > 0 and sweep % ce == 0:
            stop = flush_pending() or stop  # keep the trace ordered
            checkpoint(sweep)
    stop = flush_pending() or stop

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    final_ll = (
        log_likelihood(states, batch, row_chunk=cfg.engine.jnp_row_chunk)
        .cpu().numpy().astype(np.float64)
    )
    n_sweeps = sweep - start_sweep
    tps = n_sweeps * n_real / max(wall, 1e-9)
    log.log(
        "fit_done", sweeps=n_sweeps, wall_s=wall, triplets_per_sec=tps,
        ll_best=float(final_ll.max()),
    )
    if checkpoint_path:
        checkpoint(sweep)
    return FitResult(
        states=states,
        final_loglik=final_ll,
        ll_trace=np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
        sweeps_run=sweep,
        triplets_per_sec=tps,
        wall_seconds=wall,
        dispatch=dispatch_info,
    )
