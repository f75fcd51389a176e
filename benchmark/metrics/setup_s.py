"""setup_s: seconds from process start to the window's start (imports, the
kernel library's load or build, inputs from the seed, the integrity
sentinel, the warm-up)."""


def read(run):
    return run.setup_s
