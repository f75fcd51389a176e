"""The fixed-order block sum (``csrc/block_sum.cu``) that closes every
sweep kernel of the port with no float atomics: K1 and K5a, K3 and K7, K4
and K9 write per-block partials of theta_hat, p_hat and loglik, and
:func:`block_sum` adds them up in block order.

A segment is a partial buffer ``part`` [S, nb, ld] (float32, contiguous),
the offset of the segment's first column in each row and its width ``c``:

    out[s, i] = sum over b = 0 .. nb - 1, in that order, of part[s, b, offset + i]

On a CPU tensor :func:`block_sum` runs the plain version,
:func:`block_sum_reference`; on a CUDA tensor it launches the kernel (one
launch for up to three segments) or raises.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from trigenicinteractionpredictor_tpu_torch.ops import _build

KERNEL_NAME = "cuda-block-sum"
MAX_SEGMENTS = 3


class Segment(NamedTuple):
    part: torch.Tensor  # [S, nb, ld] float32
    offset: int         # first column of the segment in a row of part
    width: int          # c: the segment's columns (its output's width)


def block_sum_reference(segments) -> List[torch.Tensor]:
    """The plain version: each segment's columns summed over the block axis."""
    return [g.part[:, :, g.offset:g.offset + g.width].sum(1) for g in segments]


def block_sum(segments) -> List[torch.Tensor]:
    """[S, c] per segment: its partials summed over the blocks in order."""
    segments = list(segments)
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"{KERNEL_NAME} takes 1..{MAX_SEGMENTS} segments, got {len(segments)}")
    if segments[0].part.device.type == "cpu":
        return block_sum_reference(segments)
    S = segments[0].part.shape[0]
    dev = segments[0].part.device
    args, outs = [], []
    for g in segments:
        if g.part.dim() != 3:
            raise ValueError(f"{KERNEL_NAME}: a partial buffer is [S, nb, ld], got "
                             f"{tuple(g.part.shape)}")
        _build.require("part", g.part, torch.float32, (S, *g.part.shape[1:]), dev)
        nb, ld = g.part.shape[1], g.part.shape[2]
        if not (0 <= g.offset and 0 <= g.width and g.offset + g.width <= ld):
            raise ValueError(f"{KERNEL_NAME}: columns {g.offset}..{g.offset + g.width} "
                             f"of rows of {ld}")
        out = torch.empty((S, g.width), dtype=torch.float32, device=dev)
        outs.append(out)
        args += [g.part.data_ptr() + 4 * g.offset, out.data_ptr(), nb, ld, g.width]
    args += [None, None, 0, 0, 0] * (MAX_SEGMENTS - len(segments))
    if S > 65535:
        raise ValueError(f"{KERNEL_NAME} takes at most 65535 restarts, got {S}")
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tip_block_sum(*args, S, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, KERNEL_NAME)
    block_sum.launches += 1
    return outs


block_sum.launches = 0
block_sum.kernel_name = KERNEL_NAME
