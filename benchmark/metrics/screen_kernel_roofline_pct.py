"""screen_kernel_roofline_pct: the least time of the window's scoring (K2's
one-rating count, 2 rows S (K^3 + K^2 + K) operations, or its bytes,
benchmark/roofline.py) over the device time of every kernel in the
traced window, copies and sets excluded; in %."""


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    return 100.0 * sum(it["bound_s"] for it in run.items) / run.trace.kernel_s
