"""Device selection for the port.

Every entry point takes an explicit device.  A CUDA request on a machine
without CUDA fails loudly instead of falling back to the CPU, and on CUDA
the plain PyTorch paths are pinned to true float32 (no TF32), so they stay
a valid reference for the hand-written kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass --device cpu (or device='cpu') to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return dev
