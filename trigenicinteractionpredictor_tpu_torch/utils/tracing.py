"""Named spans at the port's layer boundaries, recorded only while a
``torch.profiler`` session runs.

Wrap any call in ``torch.profiler.profile(activities=[CPU, CUDA])`` and
its spans (``fit``, ``fit.prepare``, ``serve.copy_in``, ...) appear in the
profile's event list and in its ``export_chrome_trace``, on the clock of
the kernels and copies they launch.  The profiler is the only switch:
with none running, :func:`span` costs one C call and returns a shared
null context, so nothing is recorded or allocated.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span when the profiler is on."""
    if torch._C._autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _OFF
