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
- ``ops.em_hybrid``     -- the hand-written CUDA sweep kernel on pre-gathered
                           theta rows (``csrc/em_hybrid.cu``)
- ``ops.em_bdg``, ``ops.em_bd``, ``ops.em_large_g`` -- the large-G sweep
                           kernels and their host plans
- ``ops.stepwise``      -- the stepwise EM update of one minibatch group
- ``train.trainer``, ``train.checkpoint`` -- classic and stepwise EM fit loops
- ``train.stream_prep`` -- host-side minibatch preparation (numpy only)
- ``train.driver``, ``analysis`` -- fold x K work units and cross-restart reports
- ``cli``               -- ``fit`` / ``cv`` / ``sweep`` / ``predict`` /
                           ``analyze`` / ``synth``

The host layer (``config``, ``data``, ``utils.logging``) is the port's own
copy of the reference's plain-NumPy modules, under the same names, so the
port imports nothing of the JAX package.
"""

__version__ = "0.1.0"

from trigenicinteractionpredictor_tpu_torch.config import Config  # noqa: F401
