"""The program's own spans in a traced run, and the CUDA runtime calls
inside the benchmark's spans around its calls into the program.

The traced run's Chrome trace (``.bench_out/<cell>.trace.json``, as
``benchmark/harness.py`` writes it) is parsed once a process and kept by
path.  A call is one ``bench.<call>`` span of the window (``bench.fit``,
``bench.serve_predict_interaction``); a program span is a host annotation
whose name does not start with ``bench.`` (``fit.prepare``,
``serve.check_ids``, ...), counted in the call whose span it starts in.
A program without spans gives calls with none, so its readers find
nothing to read.  Times are seconds.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import Counter, defaultdict
from typing import Dict, List, NamedTuple, Optional

from benchmark import trace
from benchmark.harness import OUT_DIR

# Runtime calls that hold the host until the device has caught up: the
# syncs, and the plain cudaMemcpy (a ``.cpu()`` issues cudaMemcpyAsync and
# a cudaStreamSynchronize, counted as the latter).
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})


class Call(NamedTuple):
    spans: Dict[str, float]     # program span name -> summed seconds in this call
    runtime: Dict[str, int]     # CUDA runtime call name -> count in this call


_parsed: Dict[tuple, dict] = {}


def calls_in(path: str, call: str) -> List[Call]:
    """One :class:`Call` per ``call`` span inside the trace's window, by start."""
    st = os.stat(path)
    key = (path, st.st_mtime_ns, st.st_size)
    if key not in _parsed:
        _parsed.clear()
        _parsed[key] = _index(path)
    return _parsed[key].get(call, [])


def _index(path: str) -> dict:
    """call name -> its calls, for every ``bench.`` span name of the window."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events
           if e.get("name") == trace.WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    notes = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] != trace.WINDOW and w0 <= e["ts"] < w1]
    program = [e for e in notes if not e["name"].startswith(trace.SPAN)]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime" and w0 <= e["ts"] < w1]
    by_name = defaultdict(list)
    for e in notes:
        if e["name"].startswith(trace.SPAN):
            by_name[e["name"]].append(e)
    out = {}
    for name, spans in by_name.items():
        spans.sort(key=lambda e: e["ts"])
        seconds = [defaultdict(float) for _ in spans]
        counts = [Counter() for _ in spans]
        for i, e in _held(spans, program):
            seconds[i][e["name"]] += e["dur"] * 1e-6
        for i, e in _held(spans, runtime):
            counts[i][e["name"]] += 1
        out[name] = [Call(dict(t), dict(n)) for t, n in zip(seconds, counts)]
    return out


def _held(spans: list, events: list):
    """(index of the span that holds the event's start, event), for each
    event that starts inside one of ``spans`` (sorted, not overlapping)."""
    starts = [s["ts"] for s in spans]
    for e in events:
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0 and e["ts"] < spans[i]["ts"] + spans[i]["dur"]:
            yield i, e


def calls(run, call: str) -> Optional[List[Call]]:
    """The run's ``call`` spans; None without a trace that saw the device."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    path = os.path.join(run.cell.root, OUT_DIR, run.cell.name + ".trace.json")
    found = calls_in(path, call)
    return found or None


def span_ms(run, call: str, name: str) -> Optional[float]:
    """Summed time of the program span ``name`` a ``call``, in ms; None
    where the program records no such span."""
    found = calls(run, call)
    if found is None or not any(name in c.spans for c in found):
        return None
    return 1e3 * sum(c.spans.get(name, 0.0) for c in found) / len(found)


def syncs(run, call: str) -> Optional[float]:
    """Host syncs (:data:`SYNCS`) a ``call``."""
    found = calls(run, call)
    if found is None:
        return None
    return sum(n for c in found for name, n in c.runtime.items() if name in SYNCS) / len(found)
