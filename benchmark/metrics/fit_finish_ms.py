"""fit_finish_ms: per fit, the program's ``fit.finish`` span (fit() after
the sweep loop's clock: the final L, its copy to the host, the gather)
inside the benchmark's ``bench.fit`` spans of the traced window, over
their count; in ms."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "bench.fit", "fit.finish")
