"""fit_kernel_roofline_pct: the least time of the window's EM sweeps (the
larger of their float32 operations over the peak and their bytes over
the bandwidth, benchmark/roofline.py) over the device time of every
kernel in the traced window, copies and sets excluded; in %."""


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    return 100.0 * sum(it["bound_s"] for it in run.items) / run.trace.kernel_s
