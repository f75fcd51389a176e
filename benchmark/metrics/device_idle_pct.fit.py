"""device_idle_pct.fit: the share of the traced window of the fit cells in
which no kernel, copy or set ran on the device; in %."""

from benchmark.trace import idle_pct


def read(run):
    return idle_pct(run.trace)
