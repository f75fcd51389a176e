"""fit_outside_loop_ms: per fit, the benchmark's host time around fit()
less the program's own FitResult.wall_seconds (the sweep loop): routing,
the fit batch and its host plans, the initial states' copy, the final L
and the gather; the mean over the window's fits, in ms."""


def read(run):
    return 1e3 * sum(it["host_s"] - it["prog_s"] for it in run.items) / len(run.items)
