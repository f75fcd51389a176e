"""PyTorch + CUDA port of the trigenic MMSBM engine.

A second package beside the JAX reference ``trigenicinteractionpredictor_tpu``.
It imports ``torch`` and never ``jax``; module names mirror the reference so
each counterpart is easy to find:

- ``models.mmsbm``      -- ``ModelState`` of tensors, seeded ``init_state``
- ``ops.em``            -- the plain PyTorch EM sweep (the anchor kernels are
                           held to)
- ``ops.em_bdr``        -- the hand-written CUDA sweep kernel for K <= 20
                           (``csrc/em_sweep.cu``)
- ``ops.em_large_k``    -- the hand-written CUDA sweep kernel for K = 21..64
                           (``csrc/em_sweep_large_k.cu``)
- ``ops.score``         -- the hand-written CUDA scoring kernel (``csrc/score.cu``)
- ``ops.dispatch``      -- kernel-or-plain choice per device and shape
- ``ops.scoring``, ``ops.metrics``, ``eval`` -- held-out scoring and metrics
- ``train.trainer``, ``train.checkpoint`` -- classic full-batch EM fit loop
- ``train.driver``, ``analysis`` -- fold x K work units and cross-restart reports
- ``cli``               -- ``fit`` / ``cv`` / ``sweep`` / ``predict`` /
                           ``analyze`` / ``synth``

The jax-free host layer (``config``, ``data``, ``utils.logging``) is reused
from the reference package unchanged.
"""

__version__ = "0.1.0"

from trigenicinteractionpredictor_tpu.config import Config  # noqa: F401
