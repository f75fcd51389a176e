"""Host-side minibatch preparation for stepwise / streaming EM (counterpart
of the reference's ``train/stream_prep.py``).

Each epoch the trainer asks for its dispatch groups in order; a group is
``group`` minibatches of ``mb`` rows taken from the epoch's shuffle of
the padded index space:

1. :func:`epoch_perm` -- the reference's (seed, epoch) shuffle, bit for
   bit, so a resumed run replays the permutations a fit from scratch
   draws (and a checkpoint of either package resumes in the other);
2. :func:`_gather_rows` -- the rows of a slice of the permutation; indices
   at or past ``n`` are inert padding rows (gene 0, rating 0, weight 0);
3. :class:`StreamPrep` -- one group per call, on the calling thread or,
   with ``workers`` >= 2, fanned out over a pool of spawn processes that
   write into one of two shared-memory slots.  A memmapped dataset is
   reopened by path in each worker; an in-memory one ships once at pool
   start.

With ``rsort`` in the layout (a stats function that needs rating-sorted
rows, ``ops/em_rsorted.py``) each minibatch of ``mb`` rows is stably
sorted by rating and padded into one fixed layout of ``n_tiles`` tiles of
``tile`` rows (``mb_b`` = n_tiles * tile rows), and the group carries the
tile tables as ``tiler`` [group, n_shards * n_tiles] -- the reference's
rsort branch, bit for bit.

Spawn workers import this module, so it imports NumPy only (no torch:
workers never pay for it and never touch CUDA), and it changes no
environment variable of the parent.  Two faults of the reference are not
copied: it popped the parent's ``JAX_PLATFORMS`` after starting the pool
instead of restoring it, and its ``close()`` skipped ``unlink`` when a
slot could not be unmapped.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from trigenicinteractionpredictor_tpu_torch.ops.rsort_plan import (
    apply_rating_sort,
    rating_sort_pad,
)


def epoch_perm(seed: int, epoch: int, n_padded: int) -> np.ndarray:
    """(seed, epoch)-derived shuffle of the padded index space (the
    reference's derivation, int32 below 2^31)."""
    rng = np.random.default_rng((seed ^ 0x5EED) + 7919 * (epoch + 1))
    if n_padded < 2**31:
        return rng.permutation(np.arange(n_padded, dtype=np.int32))
    return rng.permutation(n_padded)


def _gather_rows(ds_arrays, n: int, idx: np.ndarray):
    """Rows for padded-index-space ``idx``; indices >= n are inert padding
    (gene 0, rating 0, weight 0)."""
    triplets, ratings, weights = ds_arrays
    arity = triplets.shape[1]
    mask = idx < n
    src = idx[mask]
    trip = np.zeros((idx.size, arity), np.int32)
    rat = np.zeros(idx.size, np.int32)
    wts = np.zeros(idx.size, np.float32)
    trip[mask] = triplets[src]
    rat[mask] = ratings[src]
    wts[mask] = weights[src]
    return trip, rat, wts


def _prep_minibatches(ds_arrays, layout: Dict, gperm: np.ndarray) -> Dict[str, np.ndarray]:
    """Gather the minibatches covered by ``gperm`` (a slice of the epoch
    permutation, a multiple of ``mb`` rows): {"trip" [g, mb_b, arity],
    "rat" [g, mb_b], "wts" [g, mb_b]}, and with ``rsort`` each minibatch
    rating-sorted plus "tiler" [g, n_shards * n_tiles].  With ``shard`` =
    (i, count) in the layout, only the i-th of ``count`` contiguous slices
    of every minibatch (one rank's rows over a data axis)."""
    mb = layout["mb"]
    take, count = layout.get("shard", (0, 1))
    if count > 1:
        mb //= count
        gperm = gperm.reshape(-1, mb * count)[:, take * mb:(take + 1) * mb].reshape(-1)
    trip, rat, wts = _gather_rows(ds_arrays, layout["n"], gperm)
    g = gperm.size // mb
    arity = trip.shape[-1]
    if not layout["rsort"]:
        return {"trip": trip.reshape(g, mb, arity), "rat": rat.reshape(g, mb),
                "wts": wts.reshape(g, mb)}
    d_sh, ft, tile = layout["n_shards"], layout["n_tiles"], layout["tile"]
    mb_b = layout["mb_b"]
    out = {"trip": np.empty((g, mb_b, arity), np.int32),
           "rat": np.empty((g, mb_b), np.int32),
           "wts": np.empty((g, mb_b), np.float32),
           "tiler": np.empty((g, d_sh * ft), np.int32)}
    for m in range(g):
        sl = slice(m * mb, (m + 1) * mb)
        plan = rating_sort_pad(rat[sl], layout["n_ratings"], tile=tile, n_shards=d_sh,
                               n_tiles=ft)
        out["trip"][m], out["rat"][m], out["wts"][m] = apply_rating_sort(
            plan, trip[sl], rat[sl], wts[sl], n_shards=d_sh)
        out["tiler"][m] = plan.tile_r
    return out


# --- pool worker side --------------------------------------------------

_W_DS = None       # (triplets, ratings, weights) arrays in this worker
_W_LAYOUT = None
_W_SHM: Dict[str, object] = {}


def _worker_init(ds_ref, layout):
    """Pool initializer: open the dataset (by memmap path or shipped
    arrays) once per worker."""
    global _W_DS, _W_LAYOUT
    kind, payload = ds_ref
    if kind == "mmap":
        _W_DS = tuple(np.load(p, mmap_mode="r") for p in payload)
    else:
        _W_DS = payload
    _W_LAYOUT = layout


def _attach_shm(name: str):
    from multiprocessing import shared_memory

    shm = _W_SHM.get(name)
    if shm is None:
        shm = shared_memory.SharedMemory(name=name)
        _W_SHM[name] = shm
    return shm


def _worker_task(slot_spec, gperm: np.ndarray, m_lo: int, m_hi: int):
    """Prep the minibatch range [m_lo, m_hi) from its permutation slice and
    write it into the shared-memory slot (``slot_spec``: {array name:
    (shm name, shape, dtype str)} of the whole group)."""
    for name, arr in _prep_minibatches(_W_DS, _W_LAYOUT, gperm).items():
        shm_name, shape, dtype = slot_spec[name]
        dst = np.ndarray(shape, dtype=dtype, buffer=_attach_shm(shm_name).buf)
        dst[m_lo:m_hi] = arr


def _noop(_):
    return None


def _memmap_file(a: np.ndarray):
    """The .npy file ``a`` maps whole (``TripletDataset`` keeps a plain
    view of a ``load_dir`` memmap), else None."""
    m = a
    while m is not None and not isinstance(m, np.memmap):
        m = m.base
    if m is None or m.shape != a.shape or m.dtype != a.dtype:
        return None
    return getattr(m, "filename", None)


# --- parent side -------------------------------------------------------


class StreamPrep:
    """Prepares one dispatch group per :meth:`prep_group` call as host
    arrays ``{"trip", "rat", "wts"}`` (and ``"tiler"`` with ``rsort``) with
    a leading [group] axis.  ``layout`` holds seed, n, n_padded, mb, mb_b,
    group, arity, rsort, n_ratings, tile, n_shards and n_tiles (the
    reference's keys), and optionally ``shard`` (one rank's slice of every
    minibatch; ``mb_b`` is then the slice's padded rows).

    Modes:
    - in-thread: gather on the calling thread (fresh arrays each call);
    - pool: ``workers`` spawn processes write into one of two shared-memory
      slots, taken in turn; the parent ships each task its permutation
      slice and, while the epoch's last group is in the workers' hands,
      draws the next epoch's permutation.  The returned arrays are views
      of the slot: they stay valid until the next-but-one call, so the
      caller copies them out (the trainer does, into pinned memory)
      before it asks for the group after next.

    ``workers=0`` picks: a pool of min(4, cpus - 1) when there are at least
    3 cores and ~0.5M rows per group, else in-thread.  If the pool cannot
    start, prep runs in-thread and ``pool_error`` says why.
    """

    def __init__(self, ds, layout: Dict, workers: int = 0):
        self._ds_arrays = (ds.triplets, ds.ratings, ds.weights)
        self._layout = dict(layout)
        self._pool = None
        self._slots = []         # [{name: (shm, view)}] x 2
        self._toggle = 0
        self._perm_cache: Dict = {}
        self.pool_error = None
        lay = self._layout
        self._n_dispatch = max(lay["n_padded"] // (lay["group"] * lay["mb"]), 1)
        if workers == 0:
            cpus = os.cpu_count() or 1
            rows_per_group = lay["group"] * lay["mb"]
            workers = min(4, cpus - 1) if cpus >= 3 and rows_per_group >= 1 << 19 else 1
        self.workers = max(1, workers)
        if self.workers > 1:
            self._start_pool()

    def _perm(self, ep: int) -> np.ndarray:
        if self._perm_cache.get("ep") != ep:
            self._perm_cache = {
                "ep": ep,
                "perm": epoch_perm(self._layout["seed"], ep, self._layout["n_padded"]),
            }
        return self._perm_cache["perm"]

    def _ds_ref(self):
        paths = [_memmap_file(a) for a in self._ds_arrays]
        if all(paths):
            return ("mmap", paths)
        return ("arrays", self._ds_arrays)  # shipped once per worker at spawn

    def _start_pool(self):
        from concurrent.futures import ProcessPoolExecutor
        from multiprocessing import get_context

        try:
            self._pool = ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=get_context("spawn"),
                initializer=_worker_init,
                initargs=(self._ds_ref(), self._layout),
            )
            # Start the workers now: a spawn failure surfaces here, and the
            # import cost is paid before the first epoch's clock starts.
            list(self._pool.map(_noop, range(self.workers), chunksize=1))
        except (OSError, RuntimeError) as exc:  # BrokenProcessPool is a RuntimeError
            if self._pool is not None:
                self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            self.pool_error = f"{type(exc).__name__}: {exc}"
            self.workers = 1

    def _slot(self, i: int):
        """Shared-memory slot i, sized for one group, made on first use."""
        from multiprocessing import shared_memory

        while len(self._slots) <= i:
            lay = self._layout
            g, mb_b, arity = lay["group"], lay["mb_b"], lay["arity"]
            spec = {
                "trip": ((g, mb_b, arity), np.int32),
                "rat": ((g, mb_b), np.int32),
                "wts": ((g, mb_b), np.float32),
            }
            if lay["rsort"]:
                spec["tiler"] = ((g, lay["n_shards"] * lay["n_tiles"]), np.int32)
            slot = {}
            for name, (shape, dtype) in spec.items():
                nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
                shm = shared_memory.SharedMemory(create=True, size=nbytes)
                slot[name] = (shm, np.ndarray(shape, dtype=dtype, buffer=shm.buf))
            self._slots.append(slot)
        return self._slots[i]

    def prep_group(self, ep: int, d: int) -> Dict[str, np.ndarray]:
        """Host arrays of dispatch group ``d`` of epoch ``ep``."""
        lay = self._layout
        mb, g = lay["mb"], lay["group"]
        gperm = self._perm(ep)[d * g * mb : (d + 1) * g * mb]
        if self._pool is None:
            return _prep_minibatches(self._ds_arrays, lay, gperm)
        slot = self._slot(self._toggle)
        self._toggle ^= 1
        spec = {name: (shm.name, view.shape, view.dtype.str)
                for name, (shm, view) in slot.items()}
        per = -(-g // self.workers)
        futs = [
            self._pool.submit(_worker_task, spec, gperm[m * mb : min(m + per, g) * mb],
                              m, min(m + per, g))
            for m in range(0, g, per)
        ]
        if d == self._n_dispatch - 1:
            # The workers hold the epoch's last group: draw the next
            # epoch's O(N) permutation meanwhile.
            self._perm(ep + 1)
        for f in futs:
            f.result()  # raises a worker's exception here
        return {name: view for name, (_, view) in slot.items()}

    def close(self):
        """Stop the pool (waiting for its tasks, so no worker still writes
        a slot), then unmap and unlink every slot.  A slot whose views the
        caller still holds is unlinked all the same; its memory goes with
        the last view."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        slots, self._slots = self._slots, []
        for slot in slots:
            for name in list(slot):
                shm = slot.pop(name)[0]  # drops the slot's own view
                try:
                    shm.close()
                except BufferError:
                    pass  # views still exported: the mapping outlives them
                finally:
                    shm.unlink()
