"""The readers of the program's spans (``benchmark/spans.py`` and the five
metrics on it), on hand-made Chrome traces, then on the trace a traced
tiny CPU cell exports."""

import json
import os
import time

import pytest

from benchmark import harness, spans, trace

READERS = ["fit_prepare_ms", "fit_finish_ms", "fit_host_syncs", "screen_check_ms",
           "screen_copy_in_ms"]
SERVE = "bench.serve_predict_interaction"


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _note(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _rt(name, ts):
    return _x("cuda_runtime", name, ts, 1.0)


def _fit(t0, prepare, finish, syncs):
    """One bench.fit call at ``t0`` (10 ms long): the program's spans and
    ``syncs`` stream syncs plus one cudaMemcpyAsync, which is no sync."""
    events = [
        _note("bench.fit", t0, 10000.0),
        _note("fit", t0 + 10, 9980.0),
        _note("fit.prepare", t0 + 10, prepare),
        _note("fit.make_batch", t0 + 20, prepare / 2),
        _note("fit.plan", t0 + 30, prepare / 4),
        _note("fit.ll_fetch", t0 + 5000, 100.0),
        _note("fit.finish", t0 + 9990 - finish, finish),
        _rt("cudaMemcpyAsync", t0 + 5010),
    ]
    return events + [_rt("cudaStreamSynchronize", t0 + 5020 + i) for i in range(syncs)]


def _serve(t0, blocks):
    events = [_note(SERVE, t0, 5000.0), _note("serve", t0 + 1, 4990.0),
              _note("serve.check_ids", t0 + 2, 1500.0)]
    for b in range(blocks):
        events += [_note("serve.copy_in", t0 + 2000 + 500 * b, 200.0),
                   _note("serve.score", t0 + 2200 + 500 * b, 50.0)]
    return events + [_note("serve.copy_out", t0 + 4000, 900.0)]


def _window(events, busy=True):
    out = [_note(trace.WINDOW, 0.0, 100000.0)] + events
    if busy:
        out.append(_x("kernel", "k1", 50.0, 100.0))
    return out


def _run(tmp_path, events, name="cell"):
    root = tmp_path / name
    path = root / harness.OUT_DIR / (name + ".trace.json")
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"traceEvents": events}))
    cell = harness.Cell(name, 1, {}, {}, {}, str(root), {})
    return harness.Run(cell, 1.0, 0.1, [], trace.summarize(str(path)))


def _read(run):
    out = {}
    for name in READERS:
        mod = harness.load_module(os.path.join(harness.ROOT, "benchmark", "metrics",
                                               name + ".py"), "bench_metric_" + name)
        out[name] = mod.read(run)
    return out


def test_two_fits_nested_spans_and_syncs(tmp_path):
    events = _window(_fit(1000.0, 3000.0, 800.0, syncs=3)
                     + _fit(20000.0, 5000.0, 1200.0, syncs=1)
                     + [_rt("cudaStreamSynchronize", 15000.0),    # between the fits
                        _rt("cudaDeviceSynchronize", 25000.0)])   # inside the second
    events += _fit(200000.0, 9e4, 9e4, syncs=9)                   # after the window
    events += [_note("fit.prepare", 15000.0, 100.0)]             # outside any bench.fit
    got = _read(_run(tmp_path, events))
    assert got["fit_prepare_ms"] == pytest.approx((3.0 + 5.0) / 2)
    assert got["fit_finish_ms"] == pytest.approx((0.8 + 1.2) / 2)
    assert got["fit_host_syncs"] == pytest.approx((3 + 1 + 1) / 2)
    assert got["screen_check_ms"] is None and got["screen_copy_in_ms"] is None
    calls = spans.calls_in(str(tmp_path / "cell" / harness.OUT_DIR / "cell.trace.json"),
                           "bench.fit")
    assert len(calls) == 2
    assert calls[0].spans["fit.plan"] == pytest.approx(750e-6)
    assert calls[0].runtime == {"cudaMemcpyAsync": 1, "cudaStreamSynchronize": 3}


def test_serve_calls(tmp_path):
    events = _window(_serve(1000.0, blocks=3) + _serve(10000.0, blocks=2)
                     + [_note("serve.copy_in", 8000.0, 400.0)])  # between the calls
    got = _read(_run(tmp_path, events))
    assert got["screen_check_ms"] == pytest.approx(1.5)
    assert got["screen_copy_in_ms"] == pytest.approx((3 * 0.2 + 2 * 0.2) / 2)
    assert got["fit_prepare_ms"] is None and got["fit_host_syncs"] is None


def test_a_program_without_spans_reads_nothing_but_its_syncs(tmp_path):
    events = _window([_note("bench.fit", 1000.0, 10000.0), _x("cpu_op", "aten::to", 1100, 50),
                      _rt("cudaStreamSynchronize", 2000.0),
                      _note(SERVE, 20000.0, 5000.0)])
    got = _read(_run(tmp_path, events))
    assert got == {"fit_prepare_ms": None, "fit_finish_ms": None, "fit_host_syncs": 1.0,
                   "screen_check_ms": None, "screen_copy_in_ms": None}
    events = _window([_note("bench.fit", 1000.0, 10000.0)])
    assert _read(_run(tmp_path, events, "nosync"))["fit_host_syncs"] == 0.0


def test_no_device_time_or_no_trace_reads_nothing(tmp_path):
    events = _window(_fit(1000.0, 3000.0, 800.0, syncs=3) + _serve(20000.0, 1), busy=False)
    assert set(_read(_run(tmp_path, events)).values()) == {None}
    untraced = harness.Run(harness.Cell("untraced", 1, {}, {}, {}, str(tmp_path), {}),
                           1.0, 0.1, [], None)
    assert set(_read(untraced).values()) == {None}


def test_a_rewritten_trace_is_parsed_again(tmp_path):
    run = _run(tmp_path, _window(_fit(1000.0, 3000.0, 800.0, syncs=3)))
    assert _read(run)["fit_prepare_ms"] == pytest.approx(3.0)
    path = tmp_path / "cell" / harness.OUT_DIR / "cell.trace.json"
    path.write_text(json.dumps({"traceEvents": _window(_fit(1000.0, 6000.0, 800.0, 3))
                                + [_note("pad", 0.0, 1.0)]}))
    assert _read(run)["fit_prepare_ms"] == pytest.approx(6.0)


@pytest.mark.parametrize("cell,call,want", [
    ("tiny.fit_s10", "bench.fit",
     ["fit", "fit.prepare", "fit.check_ids", "fit.route", "fit.init_states",
      "fit.make_batch", "fit.degrees", "fit.ll_fetch", "fit.finish"]),
    ("tiny.screen", SERVE,
     ["serve", "serve.check_ids", "serve.copy_in", "serve.score", "serve.copy_out"]),
])
def test_a_traced_cpu_cell_finds_the_program_spans_in_each_call(tiny_root, cell, call, want):
    c = harness.load_cell(tiny_root, cell)
    res = harness.execute(c, 2**33 + 7, 0.3, True, "cpu", time.time())
    assert res["correct"], res["checks"]
    found = spans.calls_in(os.path.join(tiny_root, harness.OUT_DIR, cell + ".trace.json"), call)
    assert len(found) == res["attempted"]
    for one in found:
        assert set(want) <= set(one.spans), sorted(one.spans)
        assert all(t > 0 for t in one.spans.values())
        assert one.spans[want[0]] >= max(t for name, t in one.spans.items() if name != want[0])
