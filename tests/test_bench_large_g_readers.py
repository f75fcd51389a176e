"""The readers of the benchmark's large-G cell (``large_g100k.fit_s10``)
on the CPU: K4's and K5b's operations, bytes and least time
(``benchmark/roofline_large_g.py``), the per-kernel device time of a
Chrome trace (``benchmark/kernel_time.py``) and the three metrics on
them, ``fit_plan_ms``, ``bdg_estep_roofline_pct`` and
``plan_scatter_roofline_pct``, on hand-made traces."""

import json
import os
import re
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import harness, kernel_time, roofline_large_g, trace  # noqa: E402

CSRC = os.path.join(REPO, "trigenicinteractionpredictor_tpu_torch", "csrc")
K4 = ("(anonymous namespace)::em_bdg_kernel(float const*, float const*, int const*, "
      "int const*, float const*, int const*, int const*, float*, float*, float*, float*, int, "
      "int, int, int, int, int, int, int, int)")
K4_FIXUP = "(anonymous namespace)::fixup_kernel(int const*, float const*, float*, int, int, " \
           "int, int, int, int)"
K5B = ("void (anonymous namespace)::segment_kernel<4>(float const*, int const*, int const*, "
       "int const*, float*, float*, int*, int, int, int, int, int, int, int, int, int, int)")
K5B_FIXUP = "(anonymous namespace)::fixup_kernel(int const*, float*, float const*, int, int, " \
            "int, int)"
OTHER = ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
         "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)")
METRICS = ["fit_plan_ms", "bdg_estep_roofline_pct", "plan_scatter_roofline_pct"]


def test_the_bounds_are_the_kernel_tables():
    """At 131,072 rows, G = 100,000, K = 10, S = 10, R = 2: K4 0.1295 ms
    (operations), K5b at two positions 0.0439 ms (bytes)."""
    k4 = roofline_large_g.bound(*roofline_large_g.bdg_estep_work(131_072, 100_000, 10, 2, 10))
    k5b = roofline_large_g.bound(*roofline_large_g.plan_scatter_work(131_072, 100_000, 10, 10))
    assert k4[1] == "operations" and round(k4[0], 4) == 0.1295
    assert k5b[1] == "bytes" and round(k5b[0], 4) == 0.0439
    assert roofline_large_g.bdg_estep_ms(131_072, 100_000, 10, 2, 10) == k4[0]
    assert roofline_large_g.plan_scatter_ms(131_072, 100_000, 10, 10) == k5b[0]


@pytest.mark.parametrize("name,fn,params", [
    (K4, "em_bdg_kernel", None),
    (K4_FIXUP, "fixup_kernel", roofline_large_g.BDG_FIXUP),
    (K5B, "segment_kernel", None),
    (K5B_FIXUP, "fixup_kernel", roofline_large_g.SCATTER_FIXUP),
    (OTHER, "vectorized_elementwise_kernel", ("int", "at::native::FillFunctor<float>",
                                              "std::array<char*, 1ul>")),
    ("ampere_sgemm_128x64_nn", "ampere_sgemm_128x64_nn", None),
])
def test_names_split_into_function_and_parameters(name, fn, params):
    assert kernel_time.function_name(name) == fn
    if params is not None:
        assert kernel_time.parameters(name) == params
    assert kernel_time.parameters("ampere_sgemm_128x64_nn") is None


def _declared(source: str, fn: str) -> str:
    """A ``__global__`` kernel's declaration in ``source`` as the demangler
    names it: its parameter types, without names or comments."""
    with open(os.path.join(CSRC, source)) as fh:
        text = re.sub(r"//[^\n]*", "", fh.read())
    m = re.search(r"__global__ void (?:__launch_bounds__\([^)]*\) )?" + fn + r"\(([^)]*)\)",
                  text)
    assert m, (source, fn)
    types = [re.sub(r"\s*\b\w+\s*$", "", p.strip()) for p in m.group(1).split(",")]
    return f"(anonymous namespace)::{fn}({', '.join(types)})"


@pytest.mark.parametrize("source,fn,k4", [
    ("em_bdg.cu", "em_bdg_kernel", True), ("em_bdg.cu", "fixup_kernel", True),
    ("plan_scatter.cu", "segment_kernel", False), ("plan_scatter.cu", "fixup_kernel", False),
])
def test_each_kernel_of_the_sources_goes_to_its_share(source, fn, k4):
    """Both sources name a kernel ``fixup_kernel``; their parameter lists
    tell them apart."""
    name = _declared(source, fn)
    assert roofline_large_g.is_bdg_estep(name) is k4
    assert roofline_large_g.is_plan_scatter(name) is (not k4)
    if fn == "fixup_kernel":
        want = roofline_large_g.BDG_FIXUP if k4 else roofline_large_g.SCATTER_FIXUP
        assert kernel_time.parameters(name) == want


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    """A 10 ms window: two fits' K4, K5b and other kernels, a copy, and
    kernels cut by the window's edges or outside it."""
    ev = [_x("user_annotation", trace.WINDOW, 1000.0, 10000.0)]
    for t0 in (1000.0, 6000.0):
        ev += [_x("user_annotation", "bench.fit", t0, 4900.0),
               _x("user_annotation", "fit.plan", t0 + 100, 300.0),
               _x("user_annotation", "fit.plan.g1", t0 + 100, 100.0),
               _x("kernel", K4, t0 + 1000, 1000.0), _x("kernel", K4_FIXUP, t0 + 2000, 50.0),
               _x("kernel", K5B, t0 + 2100, 200.0), _x("kernel", K5B_FIXUP, t0 + 2300, 10.0),
               _x("kernel", OTHER, t0 + 2400, 40.0),
               _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t0 + 2500, 100.0)]
    ev += [_x("kernel", K4, 500.0, 1000.0),       # half inside the window
           _x("kernel", K5B, 20000.0, 500.0)]     # after it
    return ev


def _run(tmp_path, events, items, name="cell"):
    root = tmp_path / name
    path = root / harness.OUT_DIR / (name + ".trace.json")
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"traceEvents": events}))
    cell = harness.Cell(name, 1, {"n_genes": 100_000, "k": 10, "n_ratings": 2},
                        {"samples": 10}, {}, str(root), {})
    return harness.Run(cell, 1.0, 0.01, items, trace.summarize(str(path))), str(path)


def _read(run):
    return {m: harness.load_module(os.path.join(REPO, "benchmark", "metrics", m + ".py"),
                                   "bench_metric_" + m).read(run) for m in METRICS}


def test_kernel_time_sums_each_name_inside_the_window(tmp_path):
    _, path = _run(tmp_path, _events(), [])
    got = kernel_time.by_name(path)
    assert got[K4] == pytest.approx(2 * 1000e-6 + 500e-6)
    assert got[K5B] == pytest.approx(2 * 200e-6)
    assert got[K4_FIXUP] == pytest.approx(100e-6) and got[K5B_FIXUP] == pytest.approx(20e-6)
    assert got[OTHER] == pytest.approx(80e-6)
    assert not any("Memcpy" in n for n in got)


def test_the_shares_and_the_plan_span_on_a_hand_made_trace(tmp_path):
    items = [{"sweeps": 100, "updates": 100 * 131_072 * 10}] * 2
    run, _ = _run(tmp_path, _events(), items)
    got = _read(run)
    k4_s = 2 * 100 * roofline_large_g.bdg_estep_ms(131_072, 100_000, 10, 2, 10) * 1e-3
    k5b_s = 2 * 100 * roofline_large_g.plan_scatter_ms(131_072, 100_000, 10, 10) * 1e-3
    assert got["bdg_estep_roofline_pct"] == pytest.approx(100 * k4_s / 2600e-6)
    assert got["plan_scatter_roofline_pct"] == pytest.approx(100 * k5b_s / 420e-6)
    assert got["fit_plan_ms"] == pytest.approx(0.3)


def test_nothing_to_read_reads_none(tmp_path):
    items = [{"sweeps": 100, "updates": 100 * 131_072 * 10}]
    no_kernels = [e for e in _events() if "kernel" not in e["cat"]]
    no_kernels.append(_x("kernel", OTHER, 1500.0, 10.0))  # the device was busy
    run, _ = _run(tmp_path, no_kernels, items, "other")
    got = _read(run)
    assert got["bdg_estep_roofline_pct"] is None and got["plan_scatter_roofline_pct"] is None
    assert got["fit_plan_ms"] == pytest.approx(0.3)
    no_plan = [e for e in _events() if not e["name"].startswith("fit.plan")]
    assert _read(_run(tmp_path, no_plan, items, "noplan")[0])["fit_plan_ms"] is None
    untraced = harness.Run(harness.Cell("untraced", 1, {}, {}, {}, str(tmp_path), {}),
                           1.0, 0.1, items, None)
    assert set(_read(untraced).values()) == {None}
