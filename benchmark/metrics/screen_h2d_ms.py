"""screen_h2d_ms: device time of the host-to-device copies of the traced
window (the candidate blocks copied in), per call, in ms."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 1e3 * run.trace.h2d_s / len(run.items)
