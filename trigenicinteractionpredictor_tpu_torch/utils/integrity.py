"""The fit-time compute-integrity sentinel (counterpart of the reference's
``utils/integrity.py``).

Before a fit on the card, :func:`check_em_integrity` runs each kernel the
port can pick on a small numpy-seeded probe and holds its output against
the plain version on the host CPU in float32.  A probe fails when its
largest error over the output's scale, ``max|card - cpu| / max(max|cpu|,
1)``, exceeds :data:`_TOL` (the reference's 5e-3: it catches gross
corruption, not rounding), or when anything in it raises -- the kernel
call or the host plumbing around it (plans, batches).  The reference only
warned and passed on a plumbing failure; here a probe that cannot run is
a probe that did not pass.

Probes (:func:`probes`), at the base shape N = 32768, G = 512, K = 10,
R = 2 unless stated:

- ``plain``: the plain sweep on the card, one state, any arity (the
  reference's ``jnp`` probe); the rest are for arity 3 only;
- ``K1`` (``cuda-em-sweep``), S = 1;
- ``K3`` (``cuda-em-sweep-large-k``) at K = 50, G = 512, N = 2048, S = 1
  (the reference's bdrg probe shape; K3 is that regime's route here);
- ``K7`` (``cuda-em-hybrid``) at K = 25, G = 3072, N = 4096, S = 2 (K7
  takes K >= 21, so not the reference's K = 10);
- ``K4`` (``cuda-em-bdg``: K4 + K5b) and ``K5`` (``cuda-em-bd-plan``: K5a +
  K5b) on a fit's batch with the route's plans (``Sweep.batch``), on two
  identical lanes;
- ``K6`` (``cuda-em-large-g``: K5a + K5b at S = 1);
- ``K2`` (``cuda-score``) on two distinct states and 4096 rows.

The rating-sorted sweep (K9) is not probed: no dispatch route picks it,
as the reference probes only what its dispatch can pick.

On the CPU the check is a no-op.  Verdicts are cached in-process (per
device and shape) and on disk in :data:`CACHE_PATH`, keyed by the card's
name, the torch and CUDA versions, a sha256 fingerprint of the port's
``ops/*.py``, ``csrc/*.cu`` and ``csrc/*.cuh``, the shape and
:data:`_TOL`; a cached FAIL raises and names the file to delete.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import time
import warnings
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from trigenicinteractionpredictor_tpu_torch.data.packing import TripletDataset
from trigenicinteractionpredictor_tpu_torch.ops import (
    em_bd,
    em_bdg,
    em_bdr,
    em_hybrid,
    em_large_g,
    em_large_k,
    score,
)
from trigenicinteractionpredictor_tpu_torch.ops.dispatch import PLAIN_NAME, stats_fn_for
from trigenicinteractionpredictor_tpu_torch.ops.em import em_sufficient_stats, make_batch

_TOL = 5e-3
_PKG = Path(__file__).resolve().parent.parent
CACHE_PATH = str(_PKG.parent / ".integrity_cache_torch.json")


class ComputeIntegrityError(RuntimeError):
    """The card's results disagree with the host CPU's."""


class Probe(NamedTuple):
    name: str        # "K1", ..., or "plain"
    kernel: str      # the route or kernel it runs
    shape: dict      # n, g, k, r, s (s = 0: one unstacked state)
    run: Callable    # (device, shape, tamper) -> ([(card, cpu), ...], ms)


class ProbeResult(NamedTuple):
    name: str
    kernel: str
    shape: str
    err: float           # max |card - cpu| / max(max|cpu|, 1) over the outputs
    ms: float            # the card's call, synchronized
    ok: bool
    error: Optional[str]  # the exception, when one was raised


last_probes: List[ProbeResult] = []  # the results of the latest probe run
probe_runs = 0                       # probe runs in this process (not cache hits)


def _case(shape: dict, arity: int = 3, seed: int = 0):
    """numpy-seeded rows (ids, ratings, unit weights) and states: theta
    rows from a flat Dirichlet, p normalized over ratings."""
    n, g, k, r, s = (shape[x] for x in ("n", "g", "k", "r", "s"))
    rng = np.random.default_rng(seed)
    trip = rng.integers(0, g, size=(n, arity), dtype=np.int32)
    rat = rng.integers(0, r, size=n, dtype=np.int32)
    w = np.ones(n, np.float32)
    theta = rng.dirichlet(np.ones(k), size=(max(s, 1), g)).astype(np.float32)
    p = rng.random((max(s, 1),) + (k,) * arity + (r,), dtype=np.float32) + 0.05
    p /= p.sum(-1, keepdims=True)
    if s == 0:
        theta, p = theta[0], p[0]
    return trip, rat, w, torch.from_numpy(theta), torch.from_numpy(p)


def _timed(dev: torch.device, call: Callable):
    t0 = time.perf_counter()
    out = call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def _stats_pairs(got, want, lanes=None):
    """(card, cpu) pairs of each SweepStats output; with ``lanes``, each
    lane of ``got`` against the single-state ``want``."""
    if lanes is None:
        return list(zip(got, want))
    return [(g[i], w) for i in range(lanes) for g, w in zip(got, want)]


def _run_plain(dev, shape, tamper, arity=3):
    trip, rat, w, theta, p = _case(shape, arity)
    want = em_sufficient_stats(theta, p, make_batch(trip, rat, w, "cpu"))
    batch = make_batch(trip, rat, w, dev)
    got, ms = _timed(dev, lambda: tamper(em_sufficient_stats(theta.to(dev), p.to(dev), batch)))
    return _stats_pairs(got, want), ms


def _sweep_runner(stats_fn, seed: int = 0):
    """A probe of a whole-ensemble sweep taking (thetas, ps, batch) on rows
    as drawn, S distinct states."""

    def run(dev, shape, tamper):
        trip, rat, w, theta, p = _case(shape, seed=seed)
        want = em_sufficient_stats(theta, p, make_batch(trip, rat, w, "cpu"))
        batch = make_batch(trip, rat, w, dev)
        got, ms = _timed(dev, lambda: tamper(stats_fn()(theta.to(dev), p.to(dev), batch)))
        return _stats_pairs(got, want), ms

    return run


def _plan_runner(route: str):
    """A probe of a plan route (K4, K5 or K6) on its fit batch, on two
    identical lanes (S = 2) or one (S = 1), each held to the single-state
    CPU stats."""

    def run(dev, shape, tamper):
        trip, rat, w, theta, p = _case(dict(shape, s=0))
        want = em_sufficient_stats(theta, p, make_batch(trip, rat, w, "cpu"))
        g, k, r, lanes = shape["g"], shape["k"], shape["r"], shape["s"]
        sweep = stats_fn_for(route, k, r)
        batch = sweep.batch(TripletDataset(trip, rat, w, g, r), dev)[0]
        thetas = theta.to(dev).expand(lanes, g, k).contiguous()
        ps = p.to(dev).expand((lanes,) + tuple(p.shape)).contiguous()
        got, ms = _timed(dev, lambda: tamper(sweep(thetas, ps, batch)))
        return _stats_pairs(got, want, lanes), ms

    return run


def _run_k2(dev, shape, tamper):
    trip, _, _, theta, p = _case(shape, seed=7)
    want = score.ensemble_score_reference(theta, p, torch.from_numpy(trip))
    trip_d = torch.as_tensor(trip, device=dev)
    got, ms = _timed(dev, lambda: tamper(score.ensemble_score(theta.to(dev), p.to(dev),
                                                              trip_d)))
    return [(got, want)], ms


def probes(arity: int = 3, n: int = 32768, n_genes: int = 512, k: int = 10,
           n_ratings: int = 2) -> List[Probe]:
    """The probes of this arity at this base shape (see the module
    docstring)."""
    r = n_ratings
    base = dict(n=n, g=n_genes, k=k, r=r)
    out = [Probe("plain", PLAIN_NAME, dict(base, s=0), functools.partial(_run_plain, arity=arity))]
    if arity != 3:
        return out
    return out + [
        Probe("K1", em_bdr.KERNEL_NAME, dict(base, s=1),
              _sweep_runner(lambda: em_bdr.em_ensemble_stats)),
        Probe("K3", em_large_k.KERNEL_NAME, dict(n=2048, g=512, k=50, r=r, s=1),
              _sweep_runner(lambda: em_large_k.em_ensemble_stats, seed=2)),
        Probe("K7", em_hybrid.KERNEL_NAME, dict(n=4096, g=3072, k=25, r=r, s=2),
              _sweep_runner(lambda: em_hybrid.em_ensemble_stats, seed=1)),
        Probe("K4", em_bdg.KERNEL_NAME, dict(base, s=2), _plan_runner(em_bdg.KERNEL_NAME)),
        Probe("K5", em_bd.KERNEL_NAME, dict(base, s=2), _plan_runner(em_bd.KERNEL_NAME)),
        Probe("K6", em_large_g.KERNEL_NAME, dict(base, s=1), _plan_runner(em_large_g.KERNEL_NAME)),
        Probe("K2", score.KERNEL_NAME, dict(base, n=min(n, 4096), s=2), _run_k2),
    ]


def run_probe(probe: Probe, device, tamper: Optional[Callable] = None) -> ProbeResult:
    """Run one probe; ``tamper`` (for tests) alters the card's output before
    the comparison.  Never raises: an exception fails the probe."""
    dev = torch.device(device)
    shape = ", ".join(f"{x}={probe.shape[x]}" for x in ("n", "g", "k", "r", "s"))
    try:
        pairs, ms = probe.run(dev, probe.shape, tamper or (lambda out: out))
        err = 0.0
        for got, want in pairs:
            want = want.double()
            scale = max(float(want.abs().max()), 1.0)
            err = max(err, float((got.cpu().double() - want).abs().max()) / scale)
        if not np.isfinite(err):
            err = float("inf")
        return ProbeResult(probe.name, probe.kernel, shape, err, ms, err <= _TOL, None)
    except Exception as exc:  # the kernel or its plumbing: the probe fails
        return ProbeResult(probe.name, probe.kernel, shape, float("inf"), 0.0, False,
                           f"{type(exc).__name__}: {exc}")


def run_probes(device, arity: int = 3, **shape) -> List[ProbeResult]:
    return [run_probe(p, device) for p in probes(arity, **shape)]


def code_fingerprint(pkg_dir=_PKG) -> str:
    """sha256 over the names and bytes of the port's ops/*.py, csrc/*.cu
    and csrc/*.cuh: an edited kernel or wrapper is probed again."""
    pkg = Path(pkg_dir)
    h = hashlib.sha256()
    files = [*(pkg / "ops").glob("*.py"), *(pkg / "csrc").glob("*.cu"),
             *(pkg / "csrc").glob("*.cuh")]
    for path in sorted(files, key=lambda f: (f.parent.name, f.name)):
        h.update(f"{path.parent.name}/{path.name}".encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _on_host(dev: torch.device) -> bool:
    return dev.type == "cpu"


def _device_name(dev: str) -> str:
    d = torch.device(dev)
    return torch.cuda.get_device_name(d) if d.type == "cuda" else d.type


def _read_cache() -> dict:
    try:
        with open(CACHE_PATH) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as exc:
        warnings.warn(f"integrity cache {CACHE_PATH} unreadable ({exc}); probing again")
        return {}


def _store(key: str, ok: bool) -> None:
    data = _read_cache()
    data[key] = ok
    tmp = f"{CACHE_PATH}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as fh:
            json.dump(data, fh, indent=1, sort_keys=True)
        os.replace(tmp, CACHE_PATH)
    except OSError as exc:
        warnings.warn(f"integrity verdict not cached in {CACHE_PATH}: {exc}")


@functools.lru_cache(maxsize=None)
def _verdict(dev: str, arity: int, n: int, g: int, k: int, r: int) -> Tuple[bool, str]:
    """(ok, why it failed) for this device and shape: the disk cache's
    verdict, else a fresh probe run's (then stored)."""
    global probe_runs
    key = (f"{_device_name(dev)}|torch {torch.__version__}|cuda {torch.version.cuda}|"
           f"{code_fingerprint()}|n={n},g={g},k={k},r={r},arity={arity}|tol={_TOL}")
    delete = f"delete {CACHE_PATH} to probe again"
    cached = _read_cache().get(key)
    if cached is not None:
        why = f"the cached verdict for this card and code is FAIL; {delete}"
        return bool(cached), "" if cached else why
    probe_runs += 1
    last_probes[:] = run_probes(dev, arity, n=n, n_genes=g, k=k, n_ratings=r)
    ok = all(p.ok for p in last_probes)
    _store(key, ok)
    failed = "; ".join(f"{p.name} ({p.kernel}, {p.shape}): "
                       + (p.error or f"error {p.err:.3g} over tolerance {_TOL:g}")
                       for p in last_probes if not p.ok)
    return ok, "" if ok else f"{failed} (verdict cached; {delete})"


def clear_cache() -> None:
    """Forget the in-process verdicts (the disk cache stays)."""
    _verdict.cache_clear()


def check_em_integrity(device, arity: int = 3, n: int = 32768, n_genes: int = 512,
                       k: int = 10, n_ratings: int = 2) -> bool:
    """Raise :class:`ComputeIntegrityError` unless every probe of this
    arity passes on ``device`` (cached); True on the CPU, where there is
    nothing to check."""
    dev = torch.device(device)
    if _on_host(dev):
        return True
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ok, why = _verdict(str(dev), arity, n, n_genes, k, n_ratings)
    if not ok:
        raise ComputeIntegrityError(
            "the card's EM statistics disagree with the host CPU; refusing to fit on "
            f"corrupt compute: {why}")
    return True
