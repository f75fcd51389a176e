"""plan_scatter_roofline_pct: the least time of K5b (the 2-position plan
scatter, one call a sweep; benchmark/roofline_large_g.py) over every
sweep of the traced window's fits, over K5b's device time in the window
(``segment_kernel`` and its ``fixup_kernel``, benchmark/kernel_time.py);
in %."""

from benchmark import kernel_time, roofline_large_g


def read(run):
    busy = kernel_time.seconds(run, roofline_large_g.is_plan_scatter)
    if not busy:
        return None
    return 100.0 * roofline_large_g.least_s(run, "plan_scatter") / busy
