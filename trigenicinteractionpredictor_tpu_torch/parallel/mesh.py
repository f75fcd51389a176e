"""The mesh of ranks (counterpart of the reference's ``parallel/mesh.py``).

Three axes, in the reference's order (ensemble, model, data):

- ``data``:     the triplet rows split into contiguous per-rank ranges; the
                sweep's sufficient statistics are summed over this axis;
- ``ensemble``: the restart axis split into contiguous per-rank blocks, with
                no communication until the states are gathered;
- ``model``:    p's ``l`` axis split into per-rank blocks, the large-K
                tensor-parallel sweep (``parallel/tensor_parallel.py``).

One process drives one rank.  Rank r sits at (e, m, d) with
r = (e * model + m) * data + d, as the reference reshapes its device list.
Each axis has one process group per line of the grid, made with
``new_subgroups_by_enumeration`` (``new_group`` per axis), so a collective
over ``data`` runs among the ranks that share (e, m).  ``init_device_mesh``
is not used: it sets each process's card from ``LOCAL_RANK`` when none is
current, which breaks ranks that share one card (several gloo ranks on
``cuda:0``).

Once the default group is up, every axis has a group, even of size 1, and
the collectives run on it (one rank's all_reduce returns its input), so a
world of one under NCCL runs the whole multi-rank path.  Without a default
group the mesh is :func:`single_device_mesh`: no group, no collective.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from trigenicinteractionpredictor_tpu_torch.parallel.distributed import group_timeout

DATA_AXIS = "data"
ENSEMBLE_AXIS = "ensemble"
MODEL_AXIS = "model"
AXES = (ENSEMBLE_AXIS, MODEL_AXIS, DATA_AXIS)


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: each axis's size, this rank's index
    along it and its process group (None without a default group)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Optional[Dict[str, dist.ProcessGroup]] = None

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))

    @property
    def distributed(self) -> bool:
        """True when the mesh's collectives run (a default group is up)."""
        return self.groups is not None

    @property
    def is_coordinator(self) -> bool:
        """The rank at (0, 0, 0): the one writer of checkpoints and reports."""
        return not any(self.coords.values())

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return None if self.groups is None else self.groups[axis]


def make_mesh(data: Optional[int] = None, ensemble: int = 1, model: int = 1) -> Mesh:
    """The (ensemble, model, data) mesh over every rank of the default group
    (one rank when there is none).

    ``data=None`` takes every rank the other axes leave.  Raises the
    reference's ``ValueError`` when the world does not divide by
    ensemble * model or the mesh needs more ranks than there are.  A mesh
    smaller than the world is refused as well: a rank outside it would hold
    no rows and join no collective (the reference's SPMD program runs a
    sub-mesh on a subset of devices; one process per rank cannot).
    Collective over the default group: every rank calls it, in one order.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if n % (ensemble * model) != 0:
            raise ValueError(
                f"{n} devices not divisible by ensemble*model={ensemble * model}"
            )
        data = n // (ensemble * model)
    sizes = (ensemble, model, data)
    if ensemble * model * data > n:
        raise ValueError(
            f"mesh {ensemble}x{model}x{data} needs {ensemble * model * data} devices, have {n}"
        )
    if ensemble * model * data < n:
        raise ValueError(
            f"mesh {ensemble}x{model}x{data} covers {ensemble * model * data} of {n} ranks; "
            "every rank holds one place of the mesh"
        )
    shape = dict(zip(AXES, sizes))
    if not dist.is_initialized():
        return Mesh(shape=shape, coords=dict.fromkeys(AXES, 0))
    rank = dist.get_rank()
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, sizes))))
    grid = np.arange(n).reshape(sizes)
    groups = {}
    for i, axis in enumerate(AXES):
        # The lines of the grid along this axis: ranks equal in the others.
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        groups[axis], _ = dist.new_subgroups_by_enumeration(lines.tolist(),
                                                             timeout=group_timeout())
    # NCCL makes a group's communicator at its first collective: do that
    # here, in set-up, not in a fit's first sweep.
    for group in (None, *groups.values()):
        _first_collective(group)
    return Mesh(shape=shape, coords=coords, groups=groups)


def _first_collective(group) -> None:
    dev = "cpu"
    if dist.get_backend(group) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.all_reduce(torch.zeros(1, device=dev), group=group)


def single_device_mesh() -> Mesh:
    """The one-rank mesh: no process group, no collective."""
    return Mesh(shape=dict.fromkeys(AXES, 1), coords=dict.fromkeys(AXES, 0))
