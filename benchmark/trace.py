"""The traced run: ``torch.profiler`` over the measured window, and the
reduction of its trace to device busy time, kernel and copy time, the
operations that took the most device time and the longest idle gaps.

The profiler's timeline is written as a Chrome trace under the checkout
(``.bench_out/``), read back and reduced here.  Device events are the
kernels, copies and sets the CUPTI tracer records; host events are the
operators, annotations and CUDA runtime calls.  Times are seconds.
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
import json
import os
from collections import defaultdict
from typing import List, NamedTuple, Optional

WINDOW = "bench_window"
SPAN = "bench."  # the benchmark's own spans around its calls into the program
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
                       "python_function"})
TOP = 10


class Trace(NamedTuple):
    window_s: float          # the traced window, host clock of the trace
    busy_s: float            # time in it with a kernel, copy or set on the device
    kernel_s: float          # summed kernel time (copies and sets excluded)
    h2d_s: float             # summed host-to-device copy time
    device_ops: list         # [[name, seconds], ...] the most device time, by name
    idle_gaps: list          # [[host op during the gap, seconds], ...] the longest


def _profiler_activities():
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def warm_profiler() -> None:
    """Open and close one short profile: a process's first profiler window
    can see no device time, so the measured one is never the first."""
    import torch
    from torch.profiler import profile

    with profile(activities=_profiler_activities()):
        x = torch.ones(1024, device="cuda")
        (x * 2).sum().item()


@contextlib.contextmanager
def traced(path: str):
    """Profile the body as the window; yields a list that receives the
    path of the written trace."""
    from torch.profiler import profile, record_function

    out: List[str] = []
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with profile(activities=_profiler_activities()) as prof:
        with record_function(WINDOW):
            yield out
    prof.export_chrome_trace(path)
    out.append(path)


def _merged(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(path: str) -> Optional[Trace]:
    """Reduce a Chrome trace to a :class:`Trace`; None when it holds no
    window annotation."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev, host = [], []
    for e in spans:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((a, b, e["cat"], e["name"]))
        elif e.get("cat") in HOST_CATS and e["name"] != WINDOW:
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    busy = _merged((a, b) for a, b, _, _ in dev)
    by_name = defaultdict(float)
    kernel = h2d = 0.0
    for a, b, cat, name in dev:
        by_name[name] += b - a
        if cat == "kernel":
            kernel += b - a
        elif cat == "gpu_memcpy" and "HtoD" in name:
            h2d += b - a
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host.sort(key=lambda h: h[1])
    ends = [h[1] for h in host]
    idle = []
    for a, b in heapq.nlargest(TOP, gaps, key=lambda g: g[1] - g[0]):
        idle.append([_gap_label(host, ends, 0.5 * (a + b)), (b - a) * 1e-6])
    ops = heapq.nlargest(TOP, by_name.items(), key=lambda kv: kv[1])
    return Trace(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        kernel_s=kernel * 1e-6,
        h2d_s=h2d * 1e-6,
        device_ops=[[name, us * 1e-6] for name, us in ops],
        idle_gaps=idle,
    )


def _gap_label(host, ends, mid) -> str:
    """What the host was doing at ``mid``: the innermost traced op or span
    around it, else the benchmark span around it and the last op that ended
    before it (the host was then in untraced code)."""
    inside = [h for h in host if h[0] <= mid <= h[1]]
    ops = [h for h in inside if not h[2].startswith(SPAN)]
    if ops:
        return min(ops, key=lambda h: h[1] - h[0])[2]
    where = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "window"
    i = bisect.bisect_right(ends, mid) - 1
    after = host[i][2] if i >= 0 else "the window's start"
    return f"{where}: untraced host code after {after}"


def idle_pct(trace: Optional[Trace]) -> Optional[float]:
    """The share of the traced window with nothing on the device, in %;
    None without a trace that saw the device."""
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
