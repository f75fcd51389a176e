"""Device time of single kernels in a traced run, by their names.

The traced run's Chrome trace (``.bench_out/<cell>.trace.json``, as
``benchmark/harness.py`` writes it) holds each kernel launch as a
``kernel`` event named by the kernel's demangled signature, e.g.
``void (anonymous namespace)::segment_kernel<4>(float const*, int const*,
...)``.  The kernel events inside the window are summed by that name once
a process and kept by path.  A name splits into its function name and its
parameter list, so that two kernels of one function name in two sources
(``csrc/em_bdg.cu`` and ``csrc/plan_scatter.cu`` both have a
``fixup_kernel`` in an anonymous namespace) are told apart by their
parameters.  Times are seconds.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

from benchmark import trace
from benchmark.harness import OUT_DIR

_parsed: Dict[tuple, Dict[str, float]] = {}
_TOKEN = re.compile(r"[A-Za-z_][A-Za-z_0-9:]*|\*|&")
_QUALIFIERS = frozenset({"const", "__restrict__", "__restrict", "volatile"})


def by_name(path: str) -> Dict[str, float]:
    """Kernel name -> summed device seconds of its events inside the window."""
    st = os.stat(path)
    key = (path, st.st_mtime_ns, st.st_size)
    if key not in _parsed:
        _parsed.clear()
        _parsed[key] = _sum(path)
    return _parsed[key]


def _sum(path: str) -> Dict[str, float]:
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events
           if e.get("name") == trace.WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    out = defaultdict(float)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b > a:
            out[e["name"]] += (b - a) * 1e-6
    return dict(out)


def _split_params(name: str) -> Tuple[str, Optional[str]]:
    """(what precedes the parameter list, the list's text); the list is the
    parenthesized group that ends the name, None where there is none."""
    name = name.strip()
    if not name.endswith(")"):
        return name, None
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        if name[i] == ")":
            depth += 1
        elif name[i] == "(":
            depth -= 1
            if depth == 0:
                return name[:i], name[i + 1:-1]
    return name, None


def function_name(name: str) -> str:
    """The bare function name of a demangled kernel name: no return type,
    namespace, template arguments or parameters."""
    head = _split_params(name)[0].rstrip()
    while head.endswith(">"):
        depth = 0
        for i in range(len(head) - 1, -1, -1):
            depth += {">": 1, "<": -1}.get(head[i], 0)
            if depth == 0:
                head = head[:i].rstrip()
                break
        else:
            break
    return head.split("::")[-1].split()[-1] if head.split() else head


def _param_type(text: str) -> str:
    """One parameter type as the demangler writes it: ``const int*
    __restrict__`` and ``int const*`` both give ``int const*``; a template
    type is kept as written."""
    if "<" in text:
        return " ".join(text.split())
    tokens = _TOKEN.findall(text)
    stars = "*" * tokens.count("*")
    base = " ".join(t for t in tokens if t not in _QUALIFIERS and t not in ("*", "&"))
    return f"{base} const{stars}" if stars and "const" in tokens else base + stars


def parameters(name: str) -> Optional[Tuple[str, ...]]:
    """The parameter types of a demangled kernel name, each as
    :func:`_param_type` writes it; None where the name has no parameter
    list."""
    text = _split_params(name)[1]
    if text is None:
        return None
    params, depth, cur = [], 0, []
    for c in text:
        if c in "<(":
            depth += 1
        elif c in ">)":
            depth -= 1
        if c == "," and depth == 0:
            params.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if "".join(cur).strip():
        params.append("".join(cur))
    return tuple(_param_type(p) for p in params)


def seconds(run, match: Callable[[str], bool]) -> Optional[float]:
    """Summed device time of the kernels whose name ``match`` accepts in the
    run's traced window; None without a trace that saw the device, or
    where no such kernel ran."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    path = os.path.join(run.cell.root, OUT_DIR, run.cell.name + ".trace.json")
    found = [s for name, s in by_name(path).items() if match(name)]
    return sum(found) if found else None
