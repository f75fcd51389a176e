"""The reduction of a profiler trace, on a hand-made Chrome trace."""

import json

import pytest

from benchmark import trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_busy_idle_copies_and_gap_labels(tmp_path):
    events = [
        _x("user_annotation", trace.WINDOW, 0.0, 1000.0),
        _x("user_annotation", "bench.fit", 0.0, 900.0),
        _x("cpu_op", "aten::copy_", 90.0, 10.0),
        _x("kernel", "k1", 100.0, 200.0),
        _x("kernel", "k1", 250.0, 100.0),       # overlaps the first: busy 100..350
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 500.0, 50.0),
        _x("gpu_memset", "Memset (Device)", 600.0, 10.0),
        _x("cpu_op", "aten::item", 700.0, 250.0),
        _x("kernel", "outside", 2000.0, 10.0),  # after the window: left out
        {"ph": "M", "name": "process_name"},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = trace.summarize(str(path))
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((250 + 50 + 10) * 1e-6)
    assert t.kernel_s == pytest.approx(300e-6)
    assert t.h2d_s == pytest.approx(50e-6)
    assert t.device_ops[0] == ["k1", pytest.approx(300e-6)]
    assert trace.idle_pct(t) == pytest.approx(100 * (1 - 310 / 1000))
    gaps = dict((round(s * 1e6), label) for label, s in t.idle_gaps)
    assert gaps[390] == "aten::item"                       # 610..1000, mid 805
    assert gaps[150] == "bench.fit: untraced host code after aten::copy_"  # 350..500
    assert gaps[100] == "bench.fit: untraced host code after the window's start"  # 0..100


def test_no_window_reads_nothing(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [_x("kernel", "k", 0, 1)]}))
    assert trace.summarize(str(path)) is None
    assert trace.idle_pct(None) is None
