"""fit_s.p90: the 90th percentile of the benchmark's host time around each
whole fit of the window (linear interpolation between order statistics)."""

import numpy as np


def read(run):
    return float(np.percentile([it["host_s"] for it in run.items], 90))
