"""K2: the ensemble serving kernel (``csrc/score.cu``) and its wrapper
(counterpart of the reference's ``ops/pallas_score.py``).

:func:`ensemble_score` returns the sample-averaged P(r = interact | genes)
for every row of ``triplets`` under restart-stacked thetas [S,G,K] and ps
[S,K,K,K,R].  On a CPU tensor it runs the plain version,
:func:`ensemble_score_reference`; on a CUDA tensor it launches the kernel
or raises.  Unlike the TPU kernel there is no G cap, and the interaction
rating's slice of p is packed once per call and streamed through shared
memory in stages, so K runs up to what the rows' theta tiles leave of
shared memory (:func:`score_plan`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu_torch.ops import _build
from trigenicinteractionpredictor_tpu_torch.ops.scoring import (
    ensemble_predict_interaction,
)

KERNEL_NAME = "cuda-score"
# The kernel's tiling (kWarpRows, kWarpKl, kStageM and the 8 warps of
# kMaxThreads in the source).
WARP_ROWS, WARP_KL, STAGE_M, MAX_WARPS = 64, 32, 16, 8
_SM_SMEM = 233_472       # shared memory of one H100 SM, bytes
_BLOCK_RESERVED = 1024   # of it, reserved per resident block
_SMEM_LIMIT = 232_448 - _BLOCK_RESERVED  # one block's opt-in maximum, less a margin


class ScorePlan(NamedTuple):
    wkl: int   # warps of a block along the flat (k,l) axis
    wr: int    # warps along rows: a block scores 64 * wr rows
    klp: int   # K^2 rounded up to whole chunks of 32 * wkl
    smem: int  # dynamic shared memory, bytes


def score_plan(k: int) -> Optional[ScorePlan]:
    """The launch plan at this K, or None where no block shape fits shared
    memory (K > 136) or K < 1.  A block is wkl x wr warps, wr = 8 // wkl; it
    multiplies chunks of 32 * wkl of the K^2 flat (k,l) columns.  Occupancy
    first: among the shapes that leave room for two blocks on an SM (there
    is one up to K = 50), else among all that fit, the plan takes the wkl
    that pads K^2 least (the widest on a tie: fewer rows a block, less
    theta staged).  Mirrors the kernel's shared-memory layout: two restarts
    of three [K, rows] theta tiles, two stages of [STAGE_M, chunk] of P,
    and the rows' gene ids."""
    if k < 1:
        return None
    fits = []
    for wkl in range(MAX_WARPS, 0, -1):
        wr = MAX_WARPS // wkl
        rows, chunk = WARP_ROWS * wr, WARP_KL * wkl
        smem = 4 * (2 * 3 * k * rows + 2 * STAGE_M * chunk + 3 * rows)
        if smem <= _SMEM_LIMIT:
            fits.append(ScorePlan(wkl, wr, -(-k * k // chunk) * chunk, smem))
    two_up = [p for p in fits if 2 * (p.smem + _BLOCK_RESERVED) <= _SM_SMEM]
    return min(two_up or fits, key=lambda p: p.klp, default=None)


def pack_p_reference(ps, interact_rating: int, klp: int):
    """The plain version of the kernel's pack: P[s, m, k*K + l] =
    ps[s, k, l, m, interact_rating], zero-padded along the last axis to
    ``klp``."""
    S, K = ps.shape[0], ps.shape[1]
    flat = ps[..., interact_rating].reshape(S, K * K, K).transpose(1, 2)
    return torch.nn.functional.pad(flat, (0, klp - K * K)).contiguous()


def ensemble_score_reference(thetas, ps, triplets, interact_rating: int = 1):
    """The plain version: ops/scoring.py's ensemble scorer."""
    return ensemble_predict_interaction(
        ModelState(theta=thetas, p=ps), triplets, interact_rating
    )


def ensemble_score(thetas, ps, triplets, interact_rating: int = 1):
    """Sample-averaged P(interact) per row: f32 [B]."""
    if thetas.device.type == "cpu":
        return ensemble_score_reference(thetas, ps, triplets, interact_rating)
    S, G, K = thetas.shape
    R = ps.shape[-1]
    B = triplets.shape[0]
    _build.require("thetas", thetas, torch.float32, (S, G, K), thetas.device)
    _build.require("ps", ps, torch.float32, (S, K, K, K, R), thetas.device)
    _build.require("triplets", triplets, torch.int32, (B, 3), thetas.device)
    if not 0 <= interact_rating < R:
        raise ValueError(f"interact_rating {interact_rating} outside [0, {R})")
    plan = score_plan(K)
    if plan is None:
        raise ValueError(f"{KERNEL_NAME} does not take K={K} (see score_plan)")
    out = torch.empty(B, dtype=torch.float32, device=thetas.device)
    if B == 0:
        return out
    packed = torch.empty((S, K, plan.klp), dtype=torch.float32, device=thetas.device)
    lib = _build.library()
    with torch.cuda.device(thetas.device):
        err = lib.tip_score(
            thetas.data_ptr(), ps.data_ptr(), triplets.data_ptr(), packed.data_ptr(),
            out.data_ptr(), S, B, G, K, R, interact_rating, plan.klp, plan.wkl, plan.wr,
            plan.smem, torch.cuda.current_stream(thetas.device).cuda_stream,
        )
    _build.check(err, KERNEL_NAME)
    ensemble_score.launches += 1
    return out


ensemble_score.launches = 0
ensemble_score.kernel_name = KERNEL_NAME
