"""Process bootstrap and topology (counterpart of the reference's
``parallel/distributed.py``).

A multi-rank run is one process per rank, started by ``torchrun``
(``python -m torch.distributed.run``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
:func:`maybe_initialize` joins the default process group through
``init_method="env://"``.  A plain one-process run initializes nothing and
every helper degrades to the one-rank case.

Devices (:func:`rank_device`): ``cuda`` (no index) gives each rank
``cuda:{LOCAL_RANK}``, one card per rank; a device with an index gives it
to every rank, so several ranks share one card only when the caller names
it.  The backend is ``nccl`` on CUDA and ``gloo`` on the CPU unless the
caller names one; NCCL cannot put two ranks on one card, so that request
is refused up front (NCCL would fail inside the first collective), and
gloo runs several ranks on one card.  The group's timeout bounds every
collective, so a rank that dies fails its peers instead of hanging them;
the mesh's axis groups (``parallel/mesh.py``) take the same timeout.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from trigenicinteractionpredictor_tpu_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT = timedelta(minutes=30)
# The timeout the default group was made with, for the groups made after it
# (the default group is process-wide state; this is its companion).
_group_timeout = {"value": DEFAULT_TIMEOUT}


@dataclass(frozen=True)
class ProcessTopology:
    process_index: int
    process_count: int
    local_rank: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def topology() -> ProcessTopology:
    """This process's rank, the world size and the local rank (0, 1, 0
    without a default group)."""
    if not dist.is_initialized():
        return ProcessTopology(0, 1, 0)
    return ProcessTopology(dist.get_rank(), dist.get_world_size(),
                           int(os.environ.get("LOCAL_RANK", "0")))


def group_timeout() -> timedelta:
    return _group_timeout["value"]


def _launched_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device) -> torch.device:
    """This rank's device (see the module docstring), made current on CUDA
    so that kernels launch on its stream."""
    dev = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else _launched_world()
    if dev.type == "cuda" and dev.index is None and world > 1:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        visible = torch.cuda.device_count()
        if local >= visible:
            raise ValueError(
                f"LOCAL_RANK={local} has no GPU of its own ({visible} visible): one rank "
                "per card, or several ranks on one card with --device cuda:0 "
                "--dist-backend gloo"
            )
        dev = torch.device("cuda", local)
    dev = resolve_device(dev)
    if dev.index is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def maybe_initialize(device="cuda", backend: Optional[str] = None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> ProcessTopology:
    """Join the default process group when a multi-process launch is set:
    ``WORLD_SIZE`` > 1, or a ``backend`` named under a torchrun launch
    (which runs a world of one through the collectives).  Returns the
    topology; a no-op when the group is up or no launch is set."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")
    launched = "RANK" in os.environ and "MASTER_ADDR" in os.environ
    wanted = _launched_world() > 1 or (backend is not None and launched)
    if dist.is_initialized() or not wanted:
        return topology()
    asked = torch.device(device)
    backend = backend or ("nccl" if asked.type == "cuda" else "gloo")
    if backend == "nccl":
        if asked.type != "cuda":
            raise ValueError(f"the nccl backend needs CUDA devices, not {str(device)!r}; "
                             "use --dist-backend gloo on the CPU")
        sharing = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        if asked.index is not None and sharing > 1:
            raise ValueError(
                f"nccl cannot run {sharing} ranks on one device ({asked}); pass "
                "--dist-backend gloo to share a card, or --device cuda for one card a rank"
            )
    rank_device(device)
    dist.init_process_group(backend=backend, init_method="env://", timeout=timeout)
    _group_timeout["value"] = timeout
    return topology()


def barrier() -> None:
    """Wait for every rank (a no-op without a default group)."""
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the default group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
