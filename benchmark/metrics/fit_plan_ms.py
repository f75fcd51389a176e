"""fit_plan_ms: per fit, the program's ``fit.plan`` span (building the
fit batch's plans: on the bdg route the g1 row order and the 2-position
scatter plan) inside the benchmark's ``bench.fit`` spans of the traced
window, over their count; in ms."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "bench.fit", "fit.plan")
