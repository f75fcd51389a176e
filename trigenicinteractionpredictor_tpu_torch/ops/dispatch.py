"""Sweep-kernel dispatch (counterpart of the reference's
``ops/dispatch.py::resolve_stats_fn``, reduced to the port's kernels).

``backend`` is the reference's rule (its ``:628-633``): ``"jnp"`` (or
None / "") gives the plain sweep on any device; ``"auto"`` and
``"pallas"`` give the kernels that :func:`route` names; any other name
raises.

:func:`route` is a pure function of (device type, arity, K, R, S, G, N,
static rows):

- CUDA, the trigenic family (arity 3), K <= 20 (K1's range):
  - static rows (classic EM), S >= 2 and G > 4500 (the reference's bdr /
    plan-family crossover): K4 (``cuda-em-bdg``, ``ops/em_bdg.py``) while
    the reference's bdg pad-fraction rule holds at tile 256, else K5
    (``cuda-em-bd-plan``, ``ops/em_bd.py``);
  - static rows, S = 1 and G >= 12,377: K6 (``cuda-em-large-g``,
    ``ops/em_large_g.py``);
  - otherwise K1 (``cuda-em-sweep``, ``ops/em_bdr.py``), and always K1 for
    stepwise EM (``static_rows=False``): the plan routes bake one
    whole-dataset row order, and K1 reads each row's rating, so it needs
    none of the per-minibatch rating sort the reference's bdr does;
- CUDA, arity 3, 21 <= K <= 72 (K3's plan): K7 (``cuda-em-hybrid``,
  ``ops/em_hybrid.py``) where the reference runs its hybrid kernel
  (:data:`HYBRID_BAND`, which has no entry past K = 64), else K3
  (``ops/em_large_k.py``), where the reference runs its one-hot ensemble,
  grouped or single-restart kernel.  The reference gives K = 65..72 to its
  single-restart kernel only up to G = 1000 (its VMEM envelope); K3 has
  no G cap, so the port gives it those K at any S and G;
- everything else -- the CPU, the digenic family (which the reference also
  leaves to plain code) and K >= 73 (the reference runs jnp from K = 76)
  -- the plain PyTorch sweep, summed over row chunks.

The reference splits wide ensembles into restart groups on the plan
routes (``pallas-bdg-plan-grouped``, ``pallas-bd-plan-grouped``) because of
its VMEM; the port's kernels put restarts on the grid, so one launch per
sweep takes any S.

No route returns the rating-sorted sweep K9 (``ops/em_rsorted.py``), as
the reference's dispatch never returns its rating-sorted kernel: a caller
asks for it with ``fit(..., stats_fn=em_rsorted.stats_fn(tile_b))``.

The returned function takes (thetas [S,G,K], ps [S,...,R], batch) and
carries ``kernel_name``, which the trainer records in events, checkpoints
and ``FitResult``; a plan route's function also carries ``needs_plan`` or
``needs_g1plan`` and its block widths, and the trainer attaches the plans.
``route_kernels`` names the kernel wrappers each route launches, whose
counts show that a sweep ran on its kernels.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from trigenicinteractionpredictor_tpu_torch.ops import (
    block_sum,
    em_bd,
    em_bdg,
    em_bdr,
    em_hybrid,
    em_large_g,
    em_large_k,
)
from trigenicinteractionpredictor_tpu_torch.ops.em import em_sufficient_stats

PLAIN_NAME = "torch"
MAX_RESTARTS = 65535  # every kernel puts S on the grid's y axis
BACKENDS = ("auto", "pallas", "jnp")

# The reference's bdr vs plan-family crossover (its ops/dispatch.py:341).
_BDR_BD_PLAN_CROSSOVER_G = 4500
# The reference's bdg pad-fraction rule (its ops/dispatch.py:321-335): bdg
# only while its tile-padded g1 plan would add at most a quarter of the
# rows.  The port's plans have no pad rows; the rule stays as the regime
# boundary between K4 and K5, evaluated at the reference's bdg tile (256).
_BDG_WB1 = 512
_BDG_MAX_PAD_FRAC = 0.25
_BDG_TILE = 256
# The first G at which the reference leaves bdr for its large-G path at
# S = 1 (static rows, 104,858 rows, K = 10).  From the CPU probe
# resolve_stats_fn('pallas', G, K, 512, n_samples=1, n_rows=104858),
# bisected over G: pallas-bdr up to G = 12,376, pallas-large-g from 12,377
# (K = 1: 12,954; K = 5: 12,691; K = 20: 11,793 -- its VMEM model; the
# port keeps the K = 10 boundary for every K).
LARGE_G_MIN_G = 12_377

# Where the reference runs its hybrid kernel (K7): for S restarts, K = 21 +
# i has the band HYBRID_BAND[S][i] = (G_lo, G_hi), inclusive; K past the
# tuple and S > 10 have none.  With static rows (classic EM) at S >= 2 the
# band holds only from K = 36: below it the reference's plan routes take
# those shapes first.  It is the reference's VMEM envelope, not a model of
# this card, and it does not depend on N (checked at N = 0, 2^20, 10^7).
# From the CPU probe (2026-10-16), for static rows in (True, False), S in
# 1..10, K in 21..64, G bisected between steps of 250 in 500..14,000:
#   resolve_stats_fn('pallas', G, K, 512, n_samples=S, static_rows=static,
#                    minibatch_rsort=not static, n_rows=104858).kernel_name
#   == 'pallas-hybrid'
HYBRID_BAND = {
    1: (
        (4488, 8955), (4456, 8889), (4422, 8821), (4388, 8751), (4352, 8679), (4315, 8604),
        (4277, 8527), (4237, 8447), (4197, 8365), (4155, 8280), (4111, 8193), (4067, 8103),
        (4021, 8010), (3974, 7915), (3925, 7817), (3876, 7717), (3824, 7613), (3772, 7507),
        (3717, 7398), (3662, 7286), (3605, 7171), (3546, 7053), (3486, 6932), (3424, 6808),
        (3361, 6681), (3297, 6551), (3230, 6417), (3163, 6281), (3093, 6141), (3022, 5998),
        (2949, 5852), (2875, 5703), (2799, 5550), (2721, 5393), (2642, 5234), (2560, 5071),
        (2478, 4904), (2393, 4734), (2307, 4560), (2218, 4383), (2128, 4202), (2036, 4018),
        (1943, 3830), (1847, 3638),
    ),
    2: (
        (4205, 8370), (4157, 8274), (4109, 8175), (4059, 8073), (4007, 7968), (3954, 7861),
        (3900, 7750), (3843, 7636), (3786, 7520), (3726, 7399), (3665, 7276), (4067, 7149),
        (4021, 7019), (3974, 6885), (3925, 6748), (3876, 6607), (3824, 6463), (3772, 6314),
        (3717, 6162), (3662, 6007), (3605, 5847), (3546, 5683), (3486, 5516), (3424, 5344),
        (3361, 5168), (3297, 4988), (3230, 4804), (3163, 4616), (3093, 4423), (3022, 4227),
        (2949, 4025), (2875, 3820), (2799, 3609), (2721, 3395), (2642, 3176), (2560, 2952),
        (2478, 2723),
    ),
    3: (
        (3948, 7840), (3888, 7718), (3827, 7594), (3764, 7466), (3700, 7335), (3634, 7201),
        (3566, 7064), (3497, 6923), (3425, 6778), (3352, 6630), (3277, 6478), (4067, 6323),
        (4021, 6163), (3974, 5999), (3925, 5832), (3876, 5660), (3824, 5484), (3772, 5304),
        (3717, 5119), (3662, 4931), (3605, 4737), (3546, 4539), (3486, 4337), (3424, 4130),
        (3361, 3918), (3297, 3701), (3230, 3480), (3163, 3254),
    ),
    4: (
        (3714, 7357), (3644, 7214), (3572, 7069), (3499, 6920), (3424, 6768), (3348, 6612),
        (3269, 6453), (3189, 6290), (3107, 6123), (3023, 5953), (2937, 5778), (4067, 5599),
        (4021, 5417), (3974, 5230), (3925, 5038), (3876, 4842), (3824, 4642), (3772, 4437),
        (3717, 4227), (3662, 4013), (3605, 3793),
    ),
    5: (
        (3500, 6916), (3421, 6756), (3341, 6592), (3259, 6426), (3176, 6256), (3091, 6083),
        (3004, 5906), (2914, 5725), (2823, 5540), (2730, 5351), (2635, 5158), (4067, 4961),
        (4021, 4760), (3974, 4554), (3925, 4344), (3876, 4129),
    ),
    6: (
        (3304, 6511), (3218, 6336), (3130, 6158), (3041, 5977), (2951, 5792), (2858, 5604),
        (2764, 5412), (2668, 5217), (2569, 5017), (2469, 4814), (2366, 4606), (4067, 4394),
    ),
    7: (
        (3123, 6138), (3031, 5950), (2938, 5760), (2842, 5567), (2746, 5370), (2647, 5170),
        (2547, 4966), (2445, 4758), (2340, 4546), (2234, 4331), (2126, 4111),
    ),
    8: (
        (2956, 5794), (2859, 5595), (2760, 5394), (2660, 5191), (2558, 4984), (2455, 4773),
        (2349, 4559), (2242, 4341), (2133, 4120), (2022, 3894), (1908, 3664),
    ),
    9: (
        (2801, 5474), (2700, 5267), (2597, 5057), (2492, 4845), (2386, 4629), (2278, 4410),
        (2169, 4188), (2058, 3961), (1944, 3731), (1829, 3497), (1711, 3259),
    ),
    10: (
        (2657, 5178), (2552, 4963), (2445, 4745), (2337, 4525), (2228, 4302), (2116, 4076),
        (2003, 3847), (1888, 3614), (1772, 3377), (1653, 3136), (1532, 2890),
    ),
}
_HYBRID_STATIC_MIN_K = 36


def _bdg_pad_ok(n_genes: int, tile: int, n_rows: int) -> bool:
    n_eff = n_rows or 131072  # the reference's production assumption
    pad_est = -(-n_genes // _BDG_WB1) * (tile // 2)
    return pad_est <= _BDG_MAX_PAD_FRAC * n_eff


def plain_stats(thetas, ps, batch, row_chunk: int = 0):
    """The plain PyTorch sweep, as a stats function (any device, any arity);
    ``row_chunk`` > 0 sums it over chunks of that many rows."""
    return em_sufficient_stats(thetas, ps, batch, row_chunk=row_chunk)


plain_stats.kernel_name = PLAIN_NAME


def in_hybrid_band(k: int, n_samples: int, n_genes: int, static_rows: bool) -> bool:
    """True where the reference's dispatch gives its hybrid kernel."""
    band = HYBRID_BAND.get(n_samples, ())
    i = k - em_large_k.MIN_K
    if not 0 <= i < len(band):
        return False
    if static_rows and n_samples > 1 and k < _HYBRID_STATIC_MIN_K:
        return False
    lo, hi = band[i]
    return lo <= n_genes <= hi


def route(device_type: str, arity: int, k: int, n_ratings: int, n_samples: int,
          n_genes: int = 0, n_rows: int = 0, static_rows: bool = True) -> str:
    """The name of the sweep that runs at this device type and shape
    (``n_genes`` 0: unknown; ``n_rows`` 0: unknown, the reference's
    production N; ``static_rows`` False: stepwise EM, rows reshuffled every
    epoch, so no plan route)."""
    if device_type == "cuda" and arity == 3 and 1 <= n_samples <= MAX_RESTARTS:
        if em_bdr.sweep_plan(k, n_ratings) is not None:
            if static_rows and n_samples >= 2 and n_genes > _BDR_BD_PLAN_CROSSOVER_G:
                if (_bdg_pad_ok(n_genes, _BDG_TILE, n_rows)
                        and em_bdg.bdg_plan(k, n_ratings) is not None):
                    return em_bdg.KERNEL_NAME
                return em_bd.KERNEL_NAME
            if static_rows and n_samples == 1 and n_genes >= LARGE_G_MIN_G:
                return em_large_g.KERNEL_NAME
            return em_bdr.KERNEL_NAME
        if em_large_k.sweep_plan(k, n_ratings) is not None:
            if in_hybrid_band(k, n_samples, n_genes, static_rows):
                return em_hybrid.KERNEL_NAME
            return em_large_k.KERNEL_NAME
    return PLAIN_NAME


def stats_fn_for(name: str, k: int = 0, n_ratings: int = 2, row_chunk: int = 0,
                 wb: int = em_bd.DEFAULT_WB) -> Callable:
    """The stats function of a route name (``wb``: the scatter plan's gene
    block width; the bdg block wb1 follows from K and R)."""
    if name == em_bdr.KERNEL_NAME:
        return em_bdr.em_ensemble_stats
    if name == em_large_k.KERNEL_NAME:
        return em_large_k.em_ensemble_stats
    if name == em_hybrid.KERNEL_NAME:
        return em_hybrid.em_ensemble_stats
    if name == PLAIN_NAME:
        fn = functools.partial(plain_stats, row_chunk=row_chunk)
        fn.row_chunk = row_chunk
    elif name == em_bdg.KERNEL_NAME:
        wb1 = em_bdg.bdg_plan(k, n_ratings)[1]
        fn = functools.partial(em_bdg.bdg_em_ensemble_stats, wb1=wb1, wb=wb)
        fn.wb, fn.wb1 = wb, wb1
        fn.needs_g1plan = True  # g1 row order + 2-position scatter plan
    elif name in (em_bd.KERNEL_NAME, em_large_g.KERNEL_NAME):
        impl = (em_bd.bd_em_ensemble_stats if name == em_bd.KERNEL_NAME
                else em_large_g.large_g_ensemble_stats)
        fn = functools.partial(impl, wb=wb)
        fn.wb = wb
        fn.needs_plan = True    # 3-position scatter plan
    else:
        raise ValueError(f"unknown sweep route {name!r}")
    fn.kernel_name = name
    return fn


def route_kernels(name: str) -> tuple:
    """The kernel wrappers a sweep of route ``name`` launches, each once a
    sweep (none for the plain sweep); their ``launches`` counts show that
    the route ran on its kernels.  Every kernel route ends in the block sum
    of its partials, and every route whose E-step writes marginal streams
    in the plan scatter.  K1 writes streams, and so launches the plan
    scatter too, only where its private theta_hats would pass
    ``em_bdr.THETA_PART_BYTES`` (``em_bdr.theta_in_part``): not at any
    shape its route takes in the bench."""
    sums = (block_sum.block_sum,)
    kernels = {
        PLAIN_NAME: (),
        em_bdr.KERNEL_NAME: (em_bdr.em_ensemble_stats, *sums),
        em_large_k.KERNEL_NAME: (em_large_k.em_ensemble_stats, em_bd.plan_scatter, *sums),
        em_hybrid.KERNEL_NAME: (em_hybrid.hybrid_stats, em_bd.plan_scatter, *sums),
        em_bdg.KERNEL_NAME: (em_bdg.bdg_estep, em_bd.plan_scatter, *sums),
        em_bd.KERNEL_NAME: (em_bd.em_streams, em_bd.plan_scatter, *sums),
        em_large_g.KERNEL_NAME: (em_bd.em_streams, em_bd.plan_scatter, *sums),
    }
    if name not in kernels:
        raise ValueError(f"unknown sweep route {name!r}")
    return kernels[name]


def resolve_stats_fn(
    device, arity: int, n_genes: int, k: int, n_samples: int, n_ratings: int = 2,
    row_chunk: int = 0, backend: str = "auto", n_rows: int = 0,
    static_rows: bool = True,
) -> Callable:
    """The sweep-stats function for this backend, device and shape.
    ``row_chunk`` goes to the plain sweep (the reference's
    ``EngineConfig.jnp_row_chunk``); the kernels need none.  The trainer
    passes ``static_rows=not stepwise``."""
    if backend not in (None, "", *BACKENDS):
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")
    if backend in (None, "", "jnp"):
        name = PLAIN_NAME
    else:
        name = route(torch.device(device).type, arity, k, n_ratings, n_samples,
                     n_genes=n_genes, n_rows=n_rows, static_rows=static_rows)
    return stats_fn_for(name, k, n_ratings, row_chunk)
