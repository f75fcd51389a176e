"""Run one benchmark cell once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells are the ``workloads`` of ``BENCHMARK.json``.  The last line of
stdout is the result (JSON); the last lines of stderr are each number the
correctness check compared, beside its limit.  Exits non-zero with no
result when there are fewer CUDA devices than the cell asks for, when the
measured program is not in the checkout, or when the process has loaded
JAX or the JAX package.  See ``benchmark/harness.py``.
"""

import time

T0 = time.time()  # process start, as near as the script can read it

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # import the benchmark as a package and the program from the checkout

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.configure_env(ROOT)
    sys.exit(harness.main(sys.argv[1:], T0))
