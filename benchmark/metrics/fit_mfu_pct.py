"""fit_mfu_pct: the float32 operations of the window's EM sweeps over the
window's elapsed time, as a share of the card's float32 peak; in %."""

from benchmark.roofline import PEAK_F32_FLOPS


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * sum(it["flops"] for it in run.items) / run.elapsed_s / PEAK_F32_FLOPS
