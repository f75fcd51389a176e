"""fit_updates_per_s: restart-triplet EM updates (sweeps x train rows x S)
of every fit in the window, over the window's elapsed time."""


def read(run):
    return sum(it["updates"] for it in run.items) / run.elapsed_s
