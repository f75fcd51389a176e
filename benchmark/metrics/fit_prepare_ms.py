"""fit_prepare_ms: per fit, the program's ``fit.prepare`` span (fit() from
its entry to the sweep loop's clock: the id check, routing, the initial
states, the batch and its plans, the degrees) inside the benchmark's
``bench.fit`` spans of the traced window, over their count; in ms."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "bench.fit", "fit.prepare")
