"""The import guard: the benchmark measures the PyTorch port, and nothing
it runs may load JAX or the JAX package beside the port.

Modules are compared by their whole top-level name (the part before the
first dot), so ``trigenicinteractionpredictor_tpu_torch`` is allowed and
``trigenicinteractionpredictor_tpu`` is not.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "trigenicinteractionpredictor_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def check(when: str) -> None:
    """Raise ``SystemExit`` naming what was found, if anything forbidden is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"import guard ({when}): the process has loaded {', '.join(found)}; "
              "the benchmark measures the PyTorch port only", file=sys.stderr, flush=True)
        raise SystemExit(4)
