"""screen_check_ms: per call, the program's ``serve.check_ids`` span (the
candidates as a numpy array and the host's check of their gene ids)
inside the benchmark's ``bench.serve_predict_interaction`` spans of the
traced window, over their count; in ms."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "bench.serve_predict_interaction", "serve.check_ids")
