"""screen_copy_in_ms: per call, the summed host time of the program's
``serve.copy_in`` spans (each block's int32 cast and its copy from
pageable memory, staging included: the host side that screen_h2d_ms, as
device time, does not see) inside the benchmark's
``bench.serve_predict_interaction`` spans of the traced window, over
their count; in ms."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "bench.serve_predict_interaction", "serve.copy_in")
