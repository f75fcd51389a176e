"""The EM fit loops on one device (counterpart of the reference's
``train/trainer.py::fit`` and ``_run_stepwise``).

Classic (full-batch) EM: all S restarts ride a leading axis of one state;
each sweep is one call of the dispatched route (``ops/dispatch.py::Sweep``:
a kernel route on CUDA, chosen by ``cfg.engine.backend`` and the shape;
the plain sweep, chunked by ``cfg.engine.jnp_row_chunk`` rows, elsewhere
or with ``backend="jnp"``) plus ``normalize_from_stats``.  The route builds
the fit's batch with its plan, once (``Sweep.batch``).  The host loop runs
the sweeps between likelihood checks, records every ``likelihood_freq`` sweeps
the L of the state *before* the chunk's last sweep (the reference's
semantics), early-stops on |dL| < tol one check late (the trace is read
after the next chunk is queued, so the read overlaps device work), and
checkpoints.  Stepwise EM sorts every minibatch into plan tiles for a
route that carries ``tile_b`` (``ops/em_rsorted.py::stats_fn``).

Stepwise EM (``cfg.train.minibatch > 0``): see :func:`_run_stepwise`.

Under ``torch.profiler`` a classic fit records the spans ``fit``;
``fit.prepare`` (entry to the loop's clock: ``fit.check_ids``,
``fit.route``, ``fit.init_states``, ``fit.make_batch`` with ``fit.plan``,
``fit.degrees``); ``fit.ll_fetch`` per L check; ``fit.checkpoint``; and
``fit.finish`` (final L, gather, the knobs' rounds) -- ``utils/tracing.py``.

The quality knobs, as in the reference: DAEM annealing
(``anneal_beta0 < 1``) runs each sweep of the ramp through the unchanged
stats function on (theta^beta, p^beta) and normalizes the unpowered state;
``init_method="spectral"`` seeds the restarts from the data
(``models/informed_init.py``, host numpy, before the timed window); after
the main loop, split-merge rounds (:func:`_smem`) then perturb-and-resweep
rounds (:func:`_refine`) re-seed the ensemble from the best state and
resweep it through a recursive :func:`fit`.

On CUDA every fit first runs the compute-integrity sentinel
(``utils/integrity.py``), after the kernel build and before the timed
window; its verdict is cached, so only a process's first fit pays for it.

Over a mesh of ranks (``cfg.mesh``, or the ``mesh`` argument; the
reference's ``train/trainer.py`` with its ``mesh``): every rank calls
:func:`fit` with the same arguments, draws the same full ``[S, ...]``
initial states (seeded, spectral, resumed or injected) and keeps its block
of ``S // ensemble`` restarts; it builds its batch and host plans from its
own contiguous range of rows and routes with its own restarts and rows
(the reference's ``n_samples=S // ens_size``, ``n_rows=ceil(N / data)``);
each sweep's stats are summed over ``data`` (``parallel/sharded_em.py``)
and normalized with the degrees of the whole split.  The L trace and the
early stop read the restarts gathered over ``ensemble``, so every rank
stops at the same sweep.  ``mesh.model > 1`` runs the tensor-parallel
sweep (``parallel/tensor_parallel.py``, plain PyTorch, recorded as
``jnp-tp``).  ``fit`` returns the gathered states and ``final_loglik`` on
every rank, so the split-merge and refine rounds run the same lanes
everywhere; the rank at the mesh's origin alone writes checkpoints.

Refused: stepwise EM together with annealing, refine or split-merge
rounds, which the reference's stepwise loop skips without a word
(``NotImplementedError``); the spectral init above
``informed_init.MAX_GENES`` genes; and the reference's mesh refusals
(``ValueError``): samples not divisible by ``mesh.ensemble``, tensor
parallelism at arity 2, with ``minibatch > 0`` or with K not divisible by
``mesh.model``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.config import Config
from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset
from trigenicinteractionpredictor_tpu_torch.utils.logging import JsonlLogger, get_logger
from trigenicinteractionpredictor_tpu_torch.device import resolve_device
from trigenicinteractionpredictor_tpu_torch.models.mmsbm import (
    ModelState,
    init_state,
    state_from_numpy,
    to_numpy,
)
from trigenicinteractionpredictor_tpu_torch.models.informed_init import (
    MAX_GENES as SPECTRAL_MAX_GENES,
    spectral_init_arrays,
)
from trigenicinteractionpredictor_tpu_torch.models.proposals import merge_split_candidate
from trigenicinteractionpredictor_tpu_torch.ops import _build
from trigenicinteractionpredictor_tpu_torch.ops.dispatch import (
    PLAIN_NAME,
    Sweep,
    resolve_stats_fn,
    route,
    stats_fn_for,
)
from trigenicinteractionpredictor_tpu_torch.ops.em import (
    Batch,
    SweepStats,
    log_likelihood,
    make_batch,
)
from trigenicinteractionpredictor_tpu_torch.ops.stepwise import stepwise_group, zero_stats_like
from trigenicinteractionpredictor_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ENSEMBLE_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
)
from trigenicinteractionpredictor_tpu_torch.parallel.sharded_em import (
    all_reduce_packed,
    any_rank,
    block,
    gather_blocks,
    gather_loglik,
    gather_states,
    shard_ensemble,
    shard_rows,
    sharded_likelihood,
    sharded_step,
)
from trigenicinteractionpredictor_tpu_torch.parallel.tensor_parallel import (
    gather_tp_states,
    shard_tp_state,
    tp_likelihood,
    tp_step,
)
from trigenicinteractionpredictor_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from trigenicinteractionpredictor_tpu_torch.train.stream_prep import StreamPrep
from trigenicinteractionpredictor_tpu_torch.utils.integrity import check_em_integrity
from trigenicinteractionpredictor_tpu_torch.utils.tracing import span


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
    layout: dict = field(default_factory=dict)  # stepwise: minibatch, groups, padded rows


def _dispatch_extra(dispatch_info: dict) -> dict:
    """Checkpoint ``extra`` entry carrying the dispatch decision (JSON as a
    uint8 array, as the reference stores it)."""
    return {
        "dispatch_json": np.frombuffer(
            json.dumps(dispatch_info, sort_keys=True).encode(), dtype=np.uint8
        )
    }


def _anneal_schedule(tcfg) -> Optional[np.ndarray]:
    """Per-sweep DAEM inverse temperatures, or None when annealing is off
    (the reference's ``train/trainer.py::_anneal_schedule``, bit-equal).

    Geometric ramp beta0 -> 1 over ``anneal_sweeps`` (default: half the
    budget), then exact EM (beta = 1) for the remainder.
    """
    if tcfg.anneal_beta0 >= 1.0:
        return None
    A = tcfg.anneal_sweeps or max(tcfg.sweeps // 2, 1)
    t = np.arange(tcfg.sweeps, dtype=np.float64)
    ramp = tcfg.anneal_beta0 ** np.clip(1.0 - t / A, 0.0, 1.0)
    return np.minimum(ramp, 1.0).astype(np.float32)


def _check_scope(cfg: Config, n_genes: int) -> None:
    tcfg = cfg.train
    if tcfg.minibatch > 0:
        # The reference's stepwise loop returns before any of these runs, so
        # it ignores them without a word; the port refuses instead.
        knobs = [name for name, on in (
            (f"anneal_beta0={tcfg.anneal_beta0}", tcfg.anneal_beta0 < 1.0),
            (f"refine_rounds={tcfg.refine_rounds}", tcfg.refine_rounds > 0),
            (f"smem_rounds={tcfg.smem_rounds}", tcfg.smem_rounds > 0)) if on]
        if knobs:
            raise NotImplementedError(
                f"stepwise EM (minibatch={tcfg.minibatch}) does not run "
                + ", ".join(knobs) + "; use classic EM (minibatch=0) for them"
            )
    if tcfg.init_method not in ("random", "spectral"):
        raise ValueError(f"unknown init_method {tcfg.init_method!r}; use 'random' or 'spectral'")
    if tcfg.init_method == "spectral" and n_genes > SPECTRAL_MAX_GENES:
        raise ValueError(
            f"init_method='spectral' builds two dense G x G float64 co-occurrence "
            f"matrices on the host: {2 * 8 * n_genes**2 / 2**30:.1f} GiB at G={n_genes} "
            f"(limit G <= {SPECTRAL_MAX_GENES}, 8 GiB); use init_method='random'"
        )


def _check_ids(ds: TripletDataset) -> None:
    """Raise unless every real row's gene ids lie in [0, G) and its rating
    in [0, R); reads the rows in chunks (a memmapped store stays on disk)."""
    G, R = ds.n_genes, ds.n_ratings
    step = TripletDataset._HOST_CHUNK
    for i in range(0, ds.n_rows, step):
        real = np.asarray(ds.weights[i:i + step]) > 0
        trip = np.asarray(ds.triplets[i:i + step])[real]
        rat = np.asarray(ds.ratings[i:i + step])[real]
        if real.any() and (trip.min() < 0 or trip.max() >= G
                           or rat.min() < 0 or rat.max() >= R):
            raise ValueError(f"gene ids must lie in [0, {G}) and ratings in [0, {R})")


TP_NAME = "jnp-tp"  # the dispatch record of the tensor-parallel sweep (the reference's)


def _check_tp(cfg: Config, arity: int, model: int) -> None:
    """The reference's refusals of tensor parallelism (``ValueError``)."""
    if arity != 3:
        raise ValueError("tensor parallelism is trigenic-only (p is K^3)")
    if cfg.train.minibatch > 0:
        raise ValueError(
            "stepwise EM does not compose with tensor parallelism; "
            "use mesh.model=1 for minibatch mode"
        )
    if cfg.train.k % model != 0:
        raise ValueError(f"k={cfg.train.k} must divide by the model axis {model}")


def fit(
    cfg: Config,
    train_ds: TripletDataset,
    device="cuda",
    logger: Optional[JsonlLogger] = None,
    resume: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    stats_fn=None,
    init_states: Optional[ModelState] = None,
    mesh: Optional[Mesh] = None,
) -> FitResult:
    """Fit ``cfg.train.samples`` restarts of the MMSBM on a training split.

    ``resume`` -- checkpoint to continue from (same shapes).
    ``stats_fn`` -- override the dispatched route: a ``Sweep``, or a bare
    stats function (no plan; named by its ``kernel_name``).
    ``init_states`` -- restart-stacked [S, ...] initial states (tensors or
    arrays, e.g. the JAX package's) instead of the seeded random or
    spectral init (the refine and split-merge rounds pass theirs).
    ``mesh`` -- the mesh of ranks (default: ``cfg.mesh`` over the ranks of
    the default process group, ``parallel/mesh.make_mesh``).
    """
    if stats_fn is not None and not isinstance(stats_fn, Sweep):
        stats_fn = Sweep(getattr(stats_fn, "kernel_name", None)
                         or getattr(stats_fn, "__name__", type(stats_fn).__name__), stats_fn)
    with span("fit"), contextlib.ExitStack() as phase:
        phase.enter_context(span("fit.prepare"))
        _check_scope(cfg, train_ds.n_genes)
        log = logger or get_logger()
        tcfg = cfg.train
        dev = resolve_device(device)
        if cfg.engine.precision not in ("fast", "strict"):
            raise ValueError(
                f"unknown engine precision {cfg.engine.precision!r}; use 'fast' or 'strict'"
            )
        if mesh is None:
            mesh = make_mesh(data=cfg.mesh.data, ensemble=cfg.mesh.ensemble, model=cfg.mesh.model)
        data_size, ens_size, model_size = (mesh.shape[a] for a in (DATA_AXIS, ENSEMBLE_AXIS,
                                                                   MODEL_AXIS))
        S, K = tcfg.samples, tcfg.k
        if S % ens_size != 0:
            raise ValueError(f"samples={S} must divide by ensemble axis {ens_size}")
        G, R, arity = train_ds.n_genes, train_ds.n_ratings, train_ds.arity
        with span("fit.check_ids"):
            _check_ids(train_ds)
        stepwise = tcfg.minibatch > 0
        use_tp = model_size > 1
        if use_tp:
            _check_tp(cfg, arity, model_size)
        # Route with what one rank holds: its restarts and its rows.
        s_local, rows_local = S // ens_size, -(-train_ds.n_rows // data_size)

        with span("fit.route"):
            if use_tp:
                stats_fn = Sweep(TP_NAME, None)  # tp_step runs the sweep; the batch has no plan
                log.log("backend", kernel=TP_NAME, model_shards=model_size)
                kernel = route(dev.type, arity, K, R, s_local, G, n_rows=rows_local)
                if kernel != PLAIN_NAME:
                    log.log("backend_warning", message=(
                        f"mesh.model > 1 deselects the CUDA kernel ({kernel}): the "
                        "tensor-parallel sweep is plain PyTorch, a memory feature for p and its "
                        "stats past one card's memory, not a speed feature"))
            elif stats_fn is None:
                stats_fn = resolve_stats_fn(
                    dev, arity, G, K, s_local, n_ratings=R, row_chunk=cfg.engine.jnp_row_chunk,
                    backend=cfg.engine.backend, n_rows=rows_local, static_rows=not stepwise,
                )
            if stepwise and stats_fn.static_rows_only:
                # Stepwise reshuffles the rows every epoch (the reference's
                # trainer.py:228-236).
                log.log("backend", kernel=PLAIN_NAME, reason="static row order vs stepwise")
                stats_fn = stats_fn_for(PLAIN_NAME, row_chunk=cfg.engine.jnp_row_chunk or 16384)
            # Both engine precision modes run exact float32 here: the kernels use
            # no tensor cores and the plain path runs with TF32 off.
            dispatch_info = {
                "kernel": stats_fn.kernel_name,
                "tile_b": stats_fn.tile_b,
                "bdr_group": 0,
                "row_chunk": stats_fn.row_chunk,
                "precision": cfg.engine.precision,
                "backend": cfg.engine.backend,
                "device": str(dev),
            }
            log.log("dispatch", **dispatch_info)
            if dev.type == "cuda":
                # Build (or load) the CUDA kernels now, so set-up stays out of the
                # fit's wall clock.
                _build.library()
            # Refuse to train on compute that disagrees with the host CPU (a no-op
            # on the CPU; cached after a process's first fit).
            check_em_integrity(dev, arity)

        def fresh_states() -> ModelState:
            if tcfg.init_method == "spectral":
                t_init = time.perf_counter()
                th, pp = spectral_init_arrays(train_ds, K, S, seed=tcfg.seed)
                log.log("init", method="spectral", samples=S,
                        seconds=time.perf_counter() - t_init)
                return state_from_numpy(th, pp, dev)
            return init_state(G, K, R, alpha=tcfg.init_alpha, arity=arity, samples=S,
                              seed=tcfg.seed, device=dev)

        # Every rank draws (or reads) the same full [S, ...] states, then keeps
        # its block: a per-rank draw would make the mesh fit differ from the
        # one-process fit.
        start_sweep = 0
        ll_rows: List[np.ndarray] = []
        resume_extra: dict = {}
        with span("fit.init_states"):
            if init_states is not None:
                states = state_from_numpy(init_states.theta, init_states.p, dev)
            elif resume is not None:
                ck = load_checkpoint(resume, dev)
                states = ck["states"]
                start_sweep = ck["sweep"]
                if ck["ll_trace"].size:
                    ll_rows = list(np.atleast_2d(ck["ll_trace"]))
                resume_extra = ck["extra"]
                log.log("resume", path=resume, sweep=start_sweep)
            else:
                states = fresh_states()
            want = (S, G, K)
            if tuple(states.theta.shape) != want or states.arity != arity:
                raise ValueError(
                    f"initial states {tuple(states.theta.shape)} / arity {states.arity} "
                    f"do not match samples, genes, k = {want} / arity {arity}"
                )
            shard, gather = ((shard_tp_state, gather_tp_states) if use_tp
                             else (shard_ensemble, gather_states))
            states = shard(states, mesh)
        lo, hi = shard_rows(train_ds.n_rows, mesh)
        if mesh.distributed:
            log.log("shard", rows=hi - lo, first_row=lo, samples=s_local, **mesh.coords)

        if stepwise:
            carry = None
            if resume is not None:
                if "stepwise_t" in resume_extra:
                    carry = (
                        SweepStats(*(torch.as_tensor(resume_extra[name], device=dev)
                                     for name in ("ema_theta_hat", "ema_p_hat", "ema_loglik"))),
                        float(resume_extra["stepwise_t"]),
                    )
                else:
                    # A checkpoint without the EMA carry: start afresh (logged),
                    # as the reference does, so a relaunched driver unit runs.
                    log.log("stepwise_restart", ignored_resume=resume)
                    states, start_sweep, ll_rows = shard(fresh_states(), mesh), 0, []
            phase.close()  # fit.prepare ends where the stepwise epochs start
            return _run_stepwise(
                cfg, train_ds, states, stats_fn, dev, log, checkpoint_path, mesh,
                start_epoch=start_sweep, ll_rows=ll_rows, carry=carry,
                dispatch_info=dispatch_info,
            )

        with span("fit.make_batch"):
            whole = (lo, hi) == (0, train_ds.n_rows)
            shard_ds = train_ds if whole else train_ds.select(slice(lo, hi))
            batch, plan_info = stats_fn.batch(shard_ds, dev)
            if plan_info is not None:
                log.log("backend", kernel=stats_fn.kernel_name, **plan_info)
            del shard_ds
        # The degrees of the whole split, on every rank: normalizing with a
        # shard's own degrees would be wrong for every gene the shard sees less.
        with span("fit.degrees"):
            degrees = torch.as_tensor(train_ds.degrees(), device=dev)
        n_real = train_ds.n_real
        row_chunk = cfg.engine.jnp_row_chunk
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

        def checkpoint(full: ModelState, at_sweep: int) -> None:
            if mesh.is_coordinator:  # one writer
                with span("fit.checkpoint"):
                    save_checkpoint(
                        checkpoint_path, full, at_sweep,
                        np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
                        key=key_data, config_json=config_json,
                        extra=_dispatch_extra(dispatch_info),
                    )

        # DAEM: while sweep < anneal_end, the sweep's stats come from the
        # powered parameters, written into buffers allocated once per fit.
        betas = _anneal_schedule(tcfg)
        anneal_end = 0 if betas is None else (tcfg.anneal_sweeps or max(tcfg.sweeps // 2, 1))
        buffers = None
        if betas is not None:
            log.log("anneal", beta0=tcfg.anneal_beta0, ramp_sweeps=anneal_end)
            buffers = (torch.empty_like(states.theta), torch.empty_like(states.p))

        def sweep_once(states: ModelState, at: int):
            beta = None
            if at < anneal_end:
                beta = float(betas[at]) if at < len(betas) else 1.0
            if use_tp:
                return tp_step(states, batch, degrees, mesh, beta, row_chunk, buffers)
            return sharded_step(states, batch, degrees, mesh, stats_fn, beta, buffers)

        prev_check: Optional[np.ndarray] = None
        pending: Optional[Tuple[int, torch.Tensor]] = None
        phase.close()  # fit.prepare ends where the sweep loop's clock starts
        t0 = time.perf_counter()

        def flush_pending() -> bool:
            nonlocal prev_check, pending
            if pending is None:
                return False
            with span("fit.ll_fetch"):
                at_sweep, ll = pending
                pending = None
                # L of the pre-update state, every restart of the mesh.
                ll_np = gather_loglik(ll, mesh).cpu().numpy().astype(np.float64)
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
                # While the ramp runs, L rows are the annealed objective: no early
                # stop until this check and the previous one are past the ramp.
                if tcfg.tol > 0 and prev_check is not None and at_sweep >= anneal_end + 2 * freq:
                    if np.all(np.abs(ll_np - prev_check) < tcfg.tol):
                        halt = True
                halt = any_rank(halt, mesh, dev)
                if halt:
                    log.log("early_stop", sweep=at_sweep, tol=tcfg.tol)
                prev_check = ll_np
                return halt

        sweep = start_sweep
        stop = False
        while sweep < tcfg.sweeps and not stop:
            n_inner = next_boundary(sweep) - sweep
            for i in range(n_inner):
                states, ll = sweep_once(states, sweep + i)
            if tcfg.debug_nans and not (
                torch.isfinite(states.theta).all() and torch.isfinite(states.p).all()
            ):
                raise FloatingPointError(f"non-finite parameters after sweep {sweep + n_inner}")
            sweep += n_inner
            stop = flush_pending()  # the previous check syncs while this chunk runs
            if sweep % freq == 0 or sweep == tcfg.sweeps:
                pending = (sweep, ll)
            if ce > 0 and sweep % ce == 0:
                stop = flush_pending() or stop  # keep the trace ordered
                checkpoint(gather(states, mesh), sweep)
        stop = flush_pending() or stop

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        phase.enter_context(span("fit.finish"))
        final_ll = (tp_likelihood(states, batch, mesh, row_chunk) if use_tp
                    else sharded_likelihood(states, batch, mesh, row_chunk))
        final_ll = gather_loglik(final_ll, mesh).cpu().numpy().astype(np.float64)
        states = gather(states, mesh)
        del batch, buffers  # the rounds' sub-fits build their own

        # Split-merge topology jumps first, perturb-and-resweep polish after
        # (the reference's order); each adds its sub-fits' sweeps, wall time
        # and L rows.
        for rounds, stage in ((tcfg.smem_rounds, _smem), (tcfg.refine_rounds, _refine)):
            if rounds > 0:
                states, final_ll, extra = stage(cfg, train_ds, dev, log, states, final_ll,
                                                stats_fn, mesh)
                sweep += extra["sweeps"]
                wall += extra["wall"]
                ll_rows.extend(extra["ll_rows"])
        n_sweeps = sweep - start_sweep
        tps = n_sweeps * n_real / max(wall, 1e-9)
        log.log(
            "fit_done", sweeps=n_sweeps, wall_s=wall, triplets_per_sec=tps,
            ll_best=float(final_ll.max()),
        )
        if checkpoint_path:
            checkpoint(states, sweep)
        return FitResult(
            states=states,
            final_loglik=final_ll,
            ll_trace=np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
            sweeps_run=sweep,
            triplets_per_sec=tps,
            wall_seconds=wall,
            dispatch=dispatch_info,
        )


def _patch_worst_lane(cur_theta, cur_p, cur_ll, res: FitResult, lane: int):
    """Accept a refinement result by replacing only the worst original lane
    with the sub-fit's lane ``lane`` (the reference's ``_patch_worst_lane``):
    the sub-fit's lanes are correlated explorations of one basin, so
    replacing the whole ensemble would collapse the restart diversity the
    sample-averaged score relies on; patching one lane keeps the best L
    from dropping and keeps the spread."""
    worst = int(np.argmin(cur_ll))
    cur_theta, cur_p, cur_ll = cur_theta.copy(), cur_p.copy(), cur_ll.copy()
    cur_theta[worst] = to_numpy(res.states.theta[lane])
    cur_p[worst] = to_numpy(res.states.p[lane])
    cur_ll[worst] = float(res.final_loglik[lane])
    return cur_theta, cur_p, cur_ll


def _resweep_rounds(cfg, train_ds, dev, log, states, final_ll, stats_fn, mesh, *, name,
                    rounds, sweeps, seed_step, propose):
    """The loop the refine and split-merge stages share (the reference's
    ``_refine`` / ``_smem`` bodies).  Each round re-seeds all S lanes from
    the current best state: lane 0 keeps it unperturbed, ``propose(th_b,
    p_b, rng, s)`` makes lane s = 1..S-1's candidate and its move from
    ``default_rng(seed + seed_step * (round + 1))``.  The lanes resweep
    through a recursive :func:`fit` on the resolved ``stats_fn``; the best
    proposal lane is accepted (patched over the worst original lane) only
    if it beats both the incumbent and lane 0 by more than 1e-6."""
    tcfg = cfg.train
    S = tcfg.samples
    sub_cfg = cfg.replace(train=dataclasses.replace(
        tcfg, sweeps=sweeps, refine_rounds=0, smem_rounds=0, anneal_beta0=1.0,
        anneal_sweeps=0, checkpoint_every=0, init_method="random"))
    cur_theta, cur_p = to_numpy(states.theta), to_numpy(states.p)
    cur_ll = np.asarray(final_ll)
    extra = {"sweeps": 0, "wall": 0.0, "ll_rows": []}
    for rnd in range(rounds):
        best = int(np.argmax(cur_ll))
        th_b, p_b = cur_theta[best], cur_p[best]
        rng = np.random.default_rng(tcfg.seed + seed_step * (rnd + 1))
        thetas = np.repeat(th_b[None], S, axis=0).astype(np.float32)
        ps = np.repeat(p_b[None], S, axis=0).astype(np.float32)
        moves = [None]
        for s in range(1, S):
            thetas[s], ps[s], mv = propose(th_b, p_b, rng, s)
            moves.append(mv)
        log.log(name, round=rnd, from_ll=float(cur_ll.max()), sweeps=sweeps)
        res = fit(sub_cfg, train_ds, device=dev, logger=log, stats_fn=stats_fn,
                  init_states=ModelState(theta=thetas, p=ps), mesh=mesh)
        extra["sweeps"] += res.sweeps_run
        extra["wall"] += res.wall_seconds
        extra["ll_rows"].extend(list(res.ll_trace))
        lane_ll = np.asarray(res.final_loglik, dtype=np.float64)
        bar = max(float(cur_ll.max()), float(lane_ll[0])) + 1e-6
        win = 1 + int(np.argmax(lane_ll[1:]))
        accepted = bool(float(lane_ll[win]) > bar)
        if accepted:
            cur_theta, cur_p, cur_ll = _patch_worst_lane(cur_theta, cur_p, cur_ll, res, win)
        done = {"round": rnd, "to_ll": float(cur_ll.max())}
        if name == "smem":
            done["accepted_move"] = (list(map(int, moves[win]))
                                     if accepted and moves[win] else None)
        log.log(name + "_done", **done)
    return state_from_numpy(cur_theta, cur_p, dev), cur_ll, extra


def _refine(cfg, train_ds, dev, log, states, final_ll, stats_fn, mesh):
    """Perturb-and-resweep refinement (``TrainConfig.refine_rounds``): lanes
    1..S-1 mix the best state with Dirichlet(1) noise at graded strengths
    around ``refine_eps`` (the reference's ``_refine``)."""
    tcfg = cfg.train
    S = tcfg.samples
    if S < 2:
        # Perturbed candidates live in lanes 1..S-1.
        log.log("refine_skipped", reason=f"needs samples >= 2, got {S}")
        return states, np.asarray(final_ll), {"sweeps": 0, "wall": 0.0, "ll_rows": []}

    def propose(th_b, p_b, rng, s):
        G, K = th_b.shape
        R, arity = p_b.shape[-1], p_b.ndim - 1
        eps = min(tcfg.refine_eps * (0.5 + s / max(S - 1, 1)), 0.95)
        th = (1 - eps) * th_b + eps * rng.dirichlet(np.ones(K), size=G)
        pp = (1 - eps) * p_b + eps * rng.dirichlet(np.ones(R), size=(K,) * arity)
        return th, pp, None

    return _resweep_rounds(cfg, train_ds, dev, log, states, final_ll, stats_fn, mesh,
                           name="refine", rounds=tcfg.refine_rounds,
                           sweeps=tcfg.refine_sweeps or max(tcfg.sweeps // 4, 1),
                           seed_step=7717, propose=propose)


def _smem(cfg, train_ds, dev, log, states, final_ll, stats_fn, mesh):
    """Split-merge EM rounds (``TrainConfig.smem_rounds``): lanes 1..S-1
    each get an independent merge + split topology jump
    (``models/proposals.py``; the reference's ``_smem``)."""
    tcfg = cfg.train
    S, K = tcfg.samples, tcfg.k
    if K < 3 or S < 2:
        # A merge and a split need three groups; the proposals need lanes 1..S-1.
        reason = f"needs K >= 3, got {K}" if K < 3 else f"needs samples >= 2, got {S}"
        log.log("smem_skipped", reason=reason)
        return states, np.asarray(final_ll), {"sweeps": 0, "wall": 0.0, "ll_rows": []}
    return _resweep_rounds(cfg, train_ds, dev, log, states, final_ll, stats_fn, mesh,
                           name="smem", rounds=tcfg.smem_rounds,
                           sweeps=tcfg.smem_sweeps or max(tcfg.sweeps // 4, 1),
                           seed_step=9091,
                           propose=lambda th_b, p_b, rng, s: merge_split_candidate(
                               th_b, p_b, rng))


class _GroupStager:
    """Host arrays of one dispatch group -> a device :class:`Batch` with a
    leading [group] axis: trip, rat, wts and, for rating-sorted minibatches,
    tiler (their tile tables, the batch's ``tile_rating``).

    On CUDA the arrays are copied into one of two pinned host buffers, then
    to the device with ``non_blocking=True`` on a side stream; :meth:`put`
    returns the batch and the copy's event, and :meth:`ready` makes the
    compute stream wait on that event before the group's first sweep.  A
    pinned buffer is refilled only after its previous copy has finished.
    With ``one_group`` (prefetch off) a group's copy also waits until the
    previous group's sweeps are done (:meth:`consumed`), so the device
    holds one group's rows; with prefetch on it holds at most two.
    """

    _KEYS = ("trip", "rat", "wts", "tiler")  # in Batch field order

    def __init__(self, dev: torch.device, one_group: bool):
        self.dev = dev
        self.one_group = one_group
        self._pinned: List[Optional[dict]] = [None, None]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0
        self._done: Optional[torch.cuda.Event] = None
        if dev.type == "cuda":
            self._main = torch.cuda.current_stream(dev)
            self._side = torch.cuda.Stream(dev)

    def put(self, host: dict):
        keys = [k for k in self._KEYS if k in host]
        if self.dev.type != "cuda":
            return self._batch([torch.from_numpy(np.array(host[k])) for k in keys]), None
        i, self._turn = self._turn, self._turn ^ 1
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        if self._pinned[i] is None:
            self._pinned[i] = {
                k: torch.empty(host[k].shape, dtype=torch.from_numpy(host[k]).dtype,
                               pin_memory=True)
                for k in keys
            }
        for k in keys:
            self._pinned[i][k].numpy()[...] = host[k]
        if self.one_group and self._done is not None:
            self._done.synchronize()
        with torch.cuda.device(self.dev), torch.cuda.stream(self._side):
            out = [self._pinned[i][k].to(self.dev, non_blocking=True) for k in keys]
            event = torch.cuda.Event()
            event.record(self._side)
        for t in out:
            t.record_stream(self._main)  # freed only after the sweeps use it
        self._copied[i] = event
        return self._batch(out), event

    @staticmethod
    def _batch(arrays) -> Batch:
        trip, rat, wts, *tiler = arrays
        return Batch(trip, rat, wts, tile_rating=tiler[0] if tiler else None)

    def ready(self, event) -> None:
        if event is not None:
            self._main.wait_event(event)

    def consumed(self) -> None:
        if self.one_group and self.dev.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record(self._main)


def _run_stepwise(
    cfg: Config,
    train_ds: TripletDataset,
    states: ModelState,
    stats_fn: Sweep,
    dev: torch.device,
    log,
    checkpoint_path: Optional[str],
    mesh: Mesh,
    start_epoch: int = 0,
    ll_rows: Optional[List[np.ndarray]] = None,
    carry: Optional[Tuple[SweepStats, float]] = None,
    dispatch_info: Optional[dict] = None,
) -> FitResult:
    """Stepwise (incremental / minibatch) EM epochs (the reference's
    ``train/trainer.py::_run_stepwise``).

    ``cfg.train.sweeps`` counts epochs.  An epoch shuffles the padded row
    space by (seed, epoch) (``train/stream_prep.py``), cuts it into
    minibatches of ``minibatch`` rows (rounded up to a multiple of
    ``batch_pad_multiple``, not lcm'd) and runs them in dispatch groups of
    ``stream_groups`` minibatches (reduced to a divisor of their count; 0:
    the whole epoch), each through :func:`ops.stepwise.stepwise_group`.
    Only one group's rows are on the device at a time (two with
    ``stream_prefetch``, whose thread preps and copies the next group while
    the device runs this one); the dataset is never padded or copied whole,
    so a memmapped ``save_dir`` store streams off disk.  The trace row of an
    epoch is the mean of its groups' means.  Checkpoints carry the EMA
    statistics and the update counter in ``extra``, so a resumed run
    replays exactly.  The final L streams through contiguous windows of one
    group's rows.

    Over a mesh (the reference's ``make_sharded_stepwise_epoch`` and its
    ``_run_stepwise``): ``states`` and the EMA carry are this rank's block
    of restarts; every rank preps each whole group from the (seed, epoch)
    shuffle and keeps its contiguous slice of each minibatch (``P(None,
    DATA_AXIS)``; with the rating sort, the per-shard layout of
    ``n_shards = data``); ``ops/stepwise.py`` sums each minibatch's stats
    and weight over ``data``.  The trace and the early stop read the
    gathered restarts, the final L sums the ranks' row ranges, and the
    mesh's origin writes the checkpoints of the gathered states and EMA.
    """
    tcfg = cfg.train
    data_size = mesh.shape[DATA_AXIS]
    pad = math.lcm(max(cfg.engine.batch_pad_multiple, 1), data_size)
    mb = -(-tcfg.minibatch // pad) * pad
    ds = train_ds
    n = ds.n_rows
    n_padded = -(-max(n, 1) // mb) * mb
    n_mb = n_padded // mb
    if n_mb < 2:
        raise ValueError(
            f"minibatch={tcfg.minibatch} (padded to {mb}) leaves {n_mb} "
            f"minibatches of {n_padded} rows -- use classic EM instead"
        )
    group = tcfg.stream_groups if tcfg.stream_groups > 0 else n_mb
    while n_mb % group:
        group -= 1  # the largest divisor <= the request keeps epochs uniform
    n_dispatch = n_mb // group
    # A rating-sorted sweep gets every minibatch sorted into one fixed
    # padded layout: ft = mb / tile + R tiles (the worst case), so all
    # minibatches of every epoch share one shape (the reference's
    # trainer.py:947-974).  Order within a minibatch is free, and the class
    # padding is weight 0.
    tile, ft = stats_fn.tile_b, 0
    rsort = tile > 0
    if rsort:
        if (mb // data_size) % tile:
            raise ValueError(f"tile_b={tile} does not divide the padded minibatch of "
                             f"{mb} rows (minibatch={tcfg.minibatch}) split over "
                             f"{data_size} data rank(s)")
        ft = mb // data_size // tile + ds.n_ratings
    # Each rank preps its own slice of every minibatch (one shard of the
    # reference's layout: rows_b padded rows, ft tiles with the sort).
    rows_b = ft * tile if rsort else mb // data_size
    stream_prep = StreamPrep(
        ds,
        layout={"seed": tcfg.seed, "n": n, "n_padded": n_padded, "mb": mb, "mb_b": rows_b,
                "group": group, "arity": ds.arity, "rsort": rsort,
                "n_ratings": ds.n_ratings, "tile": tile, "n_shards": 1, "n_tiles": ft,
                "shard": (mesh.index(DATA_AXIS), data_size)},
        workers=tcfg.stream_prep_workers,
    )
    layout = {"minibatch": mb, "n_minibatches": n_mb,
              "stream_groups": group if n_dispatch > 1 else 0,
              "padded_rows": n_padded, "prep_workers": stream_prep.workers,
              "rsort_padded_mb": rows_b * data_size if rsort else 0}
    log.log("stepwise", kappa=tcfg.stepwise_kappa, t0=tcfg.stepwise_t0,
            prefetch=tcfg.stream_prefetch, pool_error=stream_prep.pool_error, **layout)

    degrees = torch.as_tensor(ds.degrees(), device=dev)
    n_real = ds.n_real
    w_total = torch.tensor(np.float32(ds.weight_total()), device=dev)
    if carry is not None:
        full = carry[0]
        ema = SweepStats(*(block(x, mesh, ENSEMBLE_AXIS) for x in full))
        t = torch.tensor(carry[1], dtype=torch.float32, device=dev)
        log.log("stepwise_resume", epoch=start_epoch, t=float(carry[1]))
    else:
        ema = zero_stats_like(states)
        t = torch.zeros((), dtype=torch.float32, device=dev)
    config_json = cfg.to_json()
    S = tcfg.samples
    ce = tcfg.checkpoint_every if checkpoint_path else 0
    freq = max(tcfg.likelihood_freq, 1)
    ll_rows = list(ll_rows or [])
    prev_check: Optional[np.ndarray] = None
    epoch = start_epoch
    stop = False
    prefetch = tcfg.stream_prefetch
    stager = _GroupStager(dev, one_group=not prefetch)

    def prep_group(ep: int, d: int):
        return stager.put(stream_prep.prep_group(ep, d))

    def checkpoint() -> None:
        full, ema_full = gather_states(states, mesh), [gather_blocks(x, mesh, ENSEMBLE_AXIS)
                                                       for x in ema]
        if not mesh.is_coordinator:  # one writer
            return
        save_checkpoint(
            checkpoint_path, full, epoch,
            np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
            config_json=config_json,
            extra={"ema_theta_hat": ema_full[0], "ema_p_hat": ema_full[1],
                   "ema_loglik": ema_full[2],
                   "stepwise_t": np.asarray(t.item(), dtype=np.float32),
                   **_dispatch_extra(dispatch_info or {})},
        )

    t0_wall = time.perf_counter()
    prep_pool = ThreadPoolExecutor(max_workers=1)
    prep_future = None
    try:
        while epoch < tcfg.sweeps and not stop:
            ll_groups = []
            for d in range(n_dispatch):
                if prep_future is None:
                    prep_future = prep_pool.submit(prep_group, epoch, d)
                batches, copied = prep_future.result()
                prep_future = None
                # Queue the next group's prep and copy before this group's
                # sweeps: they return once enqueued, so the thread works
                # while the device runs.
                if prefetch:
                    if d + 1 < n_dispatch:
                        prep_future = prep_pool.submit(prep_group, epoch, d + 1)
                    elif epoch + 1 < tcfg.sweeps:
                        prep_future = prep_pool.submit(prep_group, epoch + 1, 0)
                stager.ready(copied)
                states, ema, ll_g, t = stepwise_group(
                    states, ema, t, batches, degrees, w_total, stats_fn,
                    kappa=tcfg.stepwise_kappa, t0=tcfg.stepwise_t0, mesh=mesh,
                )
                del batches
                stager.consumed()
                ll_groups.append(ll_g)
                if tcfg.debug_nans and not (
                    torch.isfinite(states.theta).all() and torch.isfinite(states.p).all()
                ):
                    raise FloatingPointError(
                        f"non-finite parameters in epoch {epoch + 1}, group {d}")
            ll = torch.stack(ll_groups).mean(0)
            epoch += 1
            if epoch % freq == 0 or epoch == tcfg.sweeps:
                ll_np = gather_loglik(ll, mesh).cpu().numpy().astype(np.float64)
                ll_rows.append(ll_np)
                dt = time.perf_counter() - t0_wall
                log.log(
                    "epoch", epoch=epoch, ll_best=float(ll_np.max()),
                    ll_mean=float(ll_np.mean()),
                    triplets_per_sec=epoch * n_real / max(dt, 1e-9),
                )
                stop = any_rank(tcfg.tol > 0 and prev_check is not None
                                and bool(np.all(np.abs(ll_np - prev_check) < tcfg.tol)),
                                mesh, dev)
                if stop:
                    log.log("early_stop", epoch=epoch, tol=tcfg.tol)
                prev_check = ll_np
            if ce > 0 and epoch % ce == 0:
                checkpoint()
    finally:
        prep_pool.shutdown(wait=True)  # a queued prep must not outlive the slots
        stream_prep.close()

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0_wall
    # Final full-data L over contiguous windows of one group's rows (L is
    # additive over rows), so the device never holds more than a group;
    # each rank sums its range of rows, then the ranks' sums are added.
    window = group * mb
    final_ll = np.zeros(states.theta.shape[0], dtype=np.float64)
    first, last = shard_rows(n, mesh)
    for lo in range(first, last, window):
        hi = min(lo + window, last)
        wb = make_batch(*(np.array(a[lo:hi]) for a in (ds.triplets, ds.ratings, ds.weights)),
                        dev)
        final_ll += (log_likelihood(states, wb, row_chunk=cfg.engine.jnp_row_chunk)
                     .cpu().numpy().astype(np.float64))
    final_ll = all_reduce_packed([torch.as_tensor(final_ll, device=dev)],
                                 mesh.group(DATA_AXIS))[0]
    final_ll = gather_loglik(final_ll, mesh).cpu().numpy()
    tps = (epoch - start_epoch) * n_real / max(wall, 1e-9)
    log.log("fit_done", sweeps=epoch, wall_s=wall, triplets_per_sec=tps,
            ll_best=float(final_ll.max()), mode="stepwise")
    if checkpoint_path and epoch > start_epoch:
        checkpoint()
    return FitResult(
        states=gather_states(states, mesh),
        final_loglik=final_ll,
        ll_trace=np.stack(ll_rows) if ll_rows else np.zeros((0, S)),
        sweeps_run=epoch,
        triplets_per_sec=tps,
        wall_seconds=wall,
        dispatch=dispatch_info or {},
        layout=layout,
    )
