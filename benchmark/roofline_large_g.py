"""Operations, bytes and the least time of the bdg route's two kernels, K4
(the E-step, ``csrc/em_bdg.cu``) and K5b at two positions (the plan
scatter, ``csrc/plan_scatter.cu``), from their shapes alone, and which
kernels of a trace make up each.

Each input is read once and each output written once, as the port's
kernel table counts them (``chip_smoke.py`` phase 8's bounds); the peaks
and :func:`bound` are ``benchmark/roofline.py``'s.  At 131,072 rows, G =
100,000, K = 10, S = 10, R = 2 the least times are 0.1295 ms (K4, bound
by operations) and 0.0439 ms (K5b, bound by bytes).

- K4: a sweep's float32 operations (:func:`benchmark.roofline.sweep_flops`);
  its bytes: a sweep's (theta, p, 20 a row, theta_hat, p_hat, loglik) plus
  the position-2/3 streams it writes (4 S K bytes a row and position) and
  the g1 plan's local ids (4 a row).
- K5b: one addition a slot and column; its bytes: the streams it reads, a
  slot id and a local id a slot, theta_hat written once.
"""

from __future__ import annotations

from benchmark.kernel_time import function_name, parameters
from benchmark.roofline import bound, sweep_bytes, sweep_flops

STREAM_POSITIONS = 2  # positions 2 and 3; position 1's share stays inside K4

# The two ``fixup_kernel``s' parameter types, as the demangler writes them.
BDG_FIXUP = ("int const*", "float const*", "float*") + ("int",) * 6
SCATTER_FIXUP = ("int const*", "float*", "float const*") + ("int",) * 4


def is_bdg_estep(name: str) -> bool:
    """K4's kernels: ``em_bdg_kernel`` and em_bdg.cu's ``fixup_kernel``."""
    fn = function_name(name)
    return fn == "em_bdg_kernel" or (fn == "fixup_kernel" and parameters(name) == BDG_FIXUP)


def is_plan_scatter(name: str) -> bool:
    """K5b's kernels: ``segment_kernel`` and plan_scatter.cu's ``fixup_kernel``."""
    fn = function_name(name)
    return fn == "segment_kernel" or (fn == "fixup_kernel" and parameters(name) == SCATTER_FIXUP)


def bdg_estep_work(rows: int, g: int, k: int, r: int, s: int):
    """(float32 operations, bytes) of one K4 call."""
    streams = 4.0 * STREAM_POSITIONS * rows * s * k
    return sweep_flops(rows, k, s), sweep_bytes(rows, g, k, r, s, extra=streams + 4.0 * rows)


def plan_scatter_work(rows: int, g: int, k: int, s: int):
    """(float32 operations, bytes) of one K5b call over two positions."""
    slots = STREAM_POSITIONS * rows
    return float(slots * s * k), 4.0 * slots * s * k + 8.0 * slots + 4.0 * s * g * k


def bdg_estep_ms(rows: int, g: int, k: int, r: int, s: int) -> float:
    return bound(*bdg_estep_work(rows, g, k, r, s))[0]


def plan_scatter_ms(rows: int, g: int, k: int, s: int) -> float:
    return bound(*plan_scatter_work(rows, g, k, s))[0]


def least_s(run, kernel: str) -> float:
    """The least time of ``kernel`` ("bdg_estep" or "plan_scatter") over
    every sweep of the run's fits, in seconds: one call a sweep."""
    c, s = run.cell.config, run.cell.traffic["samples"]
    total = 0.0
    for it in run.items:
        rows = it["updates"] // (it["sweeps"] * s)
        if kernel == "bdg_estep":
            ms = bdg_estep_ms(rows, c["n_genes"], c["k"], c["n_ratings"], s)
        else:
            ms = plan_scatter_ms(rows, c["n_genes"], c["k"], s)
        total += it["sweeps"] * ms * 1e-3
    return total
