"""bdg_estep_roofline_pct: the least time of K4 (the bdg E-step, one call
a sweep; benchmark/roofline_large_g.py) over every sweep of the traced
window's fits, over K4's device time in the window (``em_bdg_kernel`` and
its ``fixup_kernel``, benchmark/kernel_time.py); in %."""

from benchmark import kernel_time, roofline_large_g


def read(run):
    busy = kernel_time.seconds(run, roofline_large_g.is_bdg_estep)
    if not busy:
        return None
    return 100.0 * roofline_large_g.least_s(run, "bdg_estep") / busy
