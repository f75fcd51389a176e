"""K2: the ensemble serving kernel (``csrc/score.cu``) and its wrapper
(counterpart of the reference's ``ops/pallas_score.py``).

:func:`ensemble_score` returns the sample-averaged P(r = interact | genes)
for every row of ``triplets`` under restart-stacked thetas [S,G,K] and ps
[S,K,K,K,R].  On a CPU tensor it runs the plain version,
:func:`ensemble_score_reference`; on a CUDA tensor it launches the kernel
or raises.  Unlike the TPU kernel there is no G cap, and p is staged in
chunks of k-slices, so K runs up to what one k-slice and the rows' theta
leave of shared memory (:func:`score_plan`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu_torch.ops import _build
from trigenicinteractionpredictor_tpu_torch.ops.scoring import (
    ensemble_predict_interaction,
)

KERNEL_NAME = "cuda-score"
THREADS = 128
_SMEM_LIMIT = 232_448 - 1024


def score_plan(k: int) -> Optional[Tuple[int, int]]:
    """(k-slices of p staged per chunk, dynamic shared-memory bytes) at this
    K: as many [K, K rounded up to 4] slices as fit beside the block's theta
    rows in half the shared memory (two blocks per SM; all of p[s] up to
    K = 26), else in all of it; None where not even one fits (K > 115) or
    K < 1."""
    if k < 1:
        return None
    theta_bytes = 4 * 3 * k * THREADS
    slice_bytes = 4 * k * (-(-k // 4) * 4)
    for limit in (_SMEM_LIMIT // 2, _SMEM_LIMIT):
        k_chunk = min(k, (limit - theta_bytes) // slice_bytes)
        if k_chunk >= 1:
            return k_chunk, theta_bytes + k_chunk * slice_bytes
    return None


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
    k_chunk, smem = plan
    out = torch.empty(B, dtype=torch.float32, device=thetas.device)
    if B == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(thetas.device):
        err = lib.tip_score(
            thetas.data_ptr(), ps.data_ptr(), triplets.data_ptr(), out.data_ptr(),
            S, B, G, K, R, interact_rating, k_chunk, THREADS, smem,
            torch.cuda.current_stream(thetas.device).cuda_stream,
        )
    _build.check(err, KERNEL_NAME)
    ensemble_score.launches += 1
    return out


ensemble_score.launches = 0
ensemble_score.kernel_name = KERNEL_NAME
