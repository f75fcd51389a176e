"""fit_host_syncs: per fit, the CUDA runtime calls that wait for the
device (stream, device and event syncs, plain cudaMemcpy;
benchmark/spans.py ``SYNCS``) inside the benchmark's ``bench.fit`` spans
of the traced window, over their count."""

from benchmark import spans


def read(run):
    return spans.syncs(run, "bench.fit")
