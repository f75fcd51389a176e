"""The route and launch checks.  A cell names the route its ``why``
measures (``route`` in ``benchmark/workloads/<cell>.json``) and a run
that the program sends down another route is refused (:func:`check_route`).
The launch check is a frozen copy of the port's ``bench.py``
``route_counters`` / ``check_launches``: a route's kernels must each have
launched once a call, else the run measured something other than its
route.  The counters and the route's kernel list are the program's own
(``fn.launches``, ``ops/dispatch.py::route_kernels``)."""

from __future__ import annotations

from typing import Callable, Dict

PLAIN_SCORER = "torch"  # ops/scoring.py::serve_route's plain scorer


def check_route(cell, route: str) -> None:
    """Raise unless ``route``, the one the program took in the warm-up, is
    the route the cell names, naming both."""
    want = cell.settings["route"]
    if route != want:
        raise RuntimeError(
            f"cell {cell.name} measures route {want}, but the program took route {route}; "
            "the run would measure something other than its cell")


def route_counters(route: str) -> Dict[str, Callable]:
    """The wrappers of the kernels ``route`` launches once a call, by kernel
    name: a sweep route's from ``route_kernels``, K2's for the serving
    scorer, none for the plain sweep or scorer."""
    from trigenicinteractionpredictor_tpu_torch.ops import score
    from trigenicinteractionpredictor_tpu_torch.ops.dispatch import route_kernels

    if route == score.KERNEL_NAME:
        fns = (score.ensemble_score,)
    elif route == PLAIN_SCORER:
        fns = ()
    else:
        fns = route_kernels(route)
    return {fn.kernel_name: fn for fn in fns}


def launch_counts(route: str) -> Dict[str, int]:
    return {name: fn.launches for name, fn in route_counters(route).items()}


def check_launches(route: str, before: Dict[str, int], calls: int) -> None:
    """Raise unless every kernel ``route`` names launched ``calls`` times
    since ``before``, naming the kernel that fell through."""
    now = launch_counts(route)
    for name in now:
        grew = now[name] - before.get(name, 0)
        if grew != calls:
            raise RuntimeError(
                f"route {route}: kernel {name} launched {grew} times for {calls} calls; "
                "the run measured something other than its route")
