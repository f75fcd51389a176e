"""screen_rows_per_s: candidate triplets scored by every call of the
window, over the window's elapsed time."""


def read(run):
    return sum(it["rows"] for it in run.items) / run.elapsed_s
