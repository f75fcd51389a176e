"""The import guard: nothing the benchmark runs may load JAX or the JAX
package (whole top-level names compared), and the run's refusals."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import guard

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_whole_top_level_names():
    names = ["jax.numpy", "jaxlib", "flax.linen", "trigenicinteractionpredictor_tpu.ops",
             "trigenicinteractionpredictor_tpu_torch.ops", "jaxtyping", "torch"]
    assert guard.forbidden_loaded(names) == ["flax", "jax", "jaxlib",
                                             "trigenicinteractionpredictor_tpu"]
    assert guard.forbidden_loaded(["trigenicinteractionpredictor_tpu_torch", "jaxtyping"]) == []


def test_no_benchmark_source_imports_a_forbidden_module():
    for dirpath, dirnames, filenames in os.walk(os.path.join(REPO, "benchmark")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                assert not guard.forbidden_loaded(mods), (f, mods)


def test_a_run_loads_nothing_forbidden():
    """A fresh interpreter runs a tiny cell through the harness and the
    program, then lists what it loaded."""
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'benchmark', 'tests')!r})\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import tempfile, conftest\n"
        "from benchmark import guard, harness\n"
        "root = conftest.build_tiny_root(tempfile.mkdtemp())\n"
        "for cell in ('tiny.fit_s1', 'tiny.screen'):\n"
        "    harness.execute(harness.load_cell(root, cell), 7, 0.1, False, 'cpu', time.time())\n"
        "print('FOUND', guard.forbidden_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


def test_run_refuses_when_jax_is_loaded():
    code = (
        "import sys, types, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "sys.modules['jax'] = types.ModuleType('jax')\n"
        "from benchmark import harness\n"
        "sys.exit(harness.main(['--workload', 'kuzmin2018_k10.fit_s10', '--seed', '1',"
        " '--seconds', '1'], time.time()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=_env(), cwd=REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "jax" in out.stderr


def test_no_result_when_a_metric_reader_loads_jax(tmp_path):
    """A metric reader added later that loads ``jax`` (a stub package on
    the path) after the window: the run exits non-zero and prints nothing
    on stdout."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    code = (
        "import json, os, sys, time\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'benchmark', 'tests')!r})\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"sys.path.append({str(tmp_path / 'stub')!r})\n"
        "import conftest\n"
        "from benchmark import harness\n"
        f"root = conftest.build_tiny_root({str(tmp_path / 'root')!r})\n"
        "with open(os.path.join(root, 'benchmark', 'metrics', 'fit_loads_jax.py'), 'w') as fh:\n"
        "    fh.write('import jax\\n\\ndef read(run):\\n    return 1.0\\n')\n"
        "path = os.path.join(root, 'BENCHMARK.json')\n"
        "spec = json.load(open(path))\n"
        "spec['per_layer'].append({'name': 'fit_loads_jax', 'unit': '%', 'better': 'higher',"
        " 'source': 'program_counter', 'layer': 'whole fit step', 'moves': 'fit_updates_per_s',"
        " 'workloads': ['tiny.fit_s1']})\n"
        "json.dump(spec, open(path, 'w'))\n"
        "cell = harness.load_cell(root, 'tiny.fit_s1')\n"
        "harness.emit(harness.execute(cell, 7, 0.1, True, 'cpu', time.time()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=_env(), cwd=REPO)
    assert out.returncode == 4, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "has loaded jax" in out.stderr


def test_run_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "kuzmin2018_k10.fit_s10", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, env=_env(),
                         cwd=tmp_path)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_run_refuses_without_a_cuda_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the refusal needs a host without one")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "kuzmin2018_k10.fit_s10", "--seed", str(2**33), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         env=_env(), cwd=REPO)
    assert out.returncode == 3 and out.stdout.strip() == ""
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout or "x")
