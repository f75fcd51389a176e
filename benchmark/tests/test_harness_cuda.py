"""On the card: one short run of a cell as the benchmark runs it, and its
control, which must come out not correct.  Skips without a CUDA device.

    python3 -m pytest benchmark/tests -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the port on the card")


def _run(*extra):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "kuzmin2018_k10.fit_s10", "--seed", str(2**33 + 11), "--seconds", "1",
                          *extra], capture_output=True, text=True, timeout=900, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_short_run_is_correct(card):
    res = _run("--trace", "0")
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert {"setup_s", "fit_updates_per_s", "fit_s.p90"} <= set(res["metrics"])


def test_traced_run_reads_the_device(card):
    res = _run("--trace", "1")
    assert res["correct"] and res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["fit_kernel_roofline_pct"]["value"] <= 100


def test_control_is_not_correct(card):
    """The control through the harness's own comparison, on three seeds."""
    out = subprocess.run([sys.executable, "benchmark/readings.py", "--workload",
                          "kuzmin2018_k10.fit_s10", "--seeds",
                          ",".join(str(2**33 + s) for s in (21, 22, 23)), "--seconds", "0.5",
                          "--control"], capture_output=True, text=True, timeout=900, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    per_seed = [x for x in lines if "seed" in x]
    assert len(per_seed) == 3 and not any(x["correct"] for x in per_seed), per_seed
