"""device_idle_pct.screen: the share of the traced window of the screen cell in
which no kernel, copy or set ran on the device; in %."""

from benchmark.trace import idle_pct


def read(run):
    return idle_pct(run.trace)
