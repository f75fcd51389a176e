"""K2: the ensemble serving kernel (``csrc/score.cu``) and its wrapper
(counterpart of the reference's ``ops/pallas_score.py``).

:func:`ensemble_score` returns the sample-averaged P(r = interact | genes)
for every row of ``triplets`` under restart-stacked thetas [S,G,K] and ps
[S,K,K,K,R].  On a CPU tensor it runs the plain version,
:func:`ensemble_score_reference`; on a CUDA tensor it launches the kernel
or raises.  Unlike the TPU kernel there is no G cap.
"""

from __future__ import annotations

from typing import Optional

import torch

from trigenicinteractionpredictor_tpu_torch.models.mmsbm import ModelState
from trigenicinteractionpredictor_tpu_torch.ops import _build
from trigenicinteractionpredictor_tpu_torch.ops.scoring import (
    ensemble_predict_interaction,
)

KERNEL_NAME = "cuda-score"
MAX_K = 32
THREADS = 128
_SMEM_LIMIT = 232_448 - 1024


def score_smem(k: int) -> Optional[int]:
    """Dynamic shared-memory bytes at this K, or None outside 1..MAX_K."""
    if not 1 <= k <= MAX_K:
        return None
    smem = 4 * (k**3 + 3 * k * THREADS)
    return smem if smem <= _SMEM_LIMIT else None


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
    smem = score_smem(K)
    if smem is None:
        raise ValueError(f"{KERNEL_NAME} does not take K={K} (1..{MAX_K})")
    out = torch.empty(B, dtype=torch.float32, device=thetas.device)
    if B == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(thetas.device):
        err = lib.tip_score(
            thetas.data_ptr(), ps.data_ptr(), triplets.data_ptr(), out.data_ptr(),
            S, B, G, K, R, interact_rating, THREADS, smem,
            torch.cuda.current_stream(thetas.device).cuda_stream,
        )
    _build.check(err, KERNEL_NAME)
    ensemble_score.launches += 1
    return out


ensemble_score.launches = 0
