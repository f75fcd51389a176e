"""Start a world of the port's ranks on the CPU for the tests (gloo), the
way torchrun starts them: one process per rank with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set.  Every wait has a timeout, and so has each worker's
process group (``WORKER_PRELUDE``), so a hung rank fails its test instead
of the run.  Workers import the port only (no jax) and pin one thread.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
from typing import List, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60   # a worker's process group: a dead peer fails it
WAIT_TIMEOUT_S = 240   # the test's wait for a whole world

WORKER_PRELUDE = f"""
import sys
from datetime import timedelta
import numpy as np
import torch
torch.set_num_threads(1)
from trigenicinteractionpredictor_tpu_torch.parallel.distributed import (
    maybe_initialize, shutdown, topology)
topo = maybe_initialize(device="cpu", timeout=timedelta(seconds={GROUP_TIMEOUT_S}))
RANK, WORLD = topo.process_index, topo.process_count
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra: dict) -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    return env


def start_world(script_path: str, world: int, args: Sequence[str] = ()) -> List[subprocess.Popen]:
    """Start ``world`` ranks of ``python script_path *args``."""
    port = str(free_port())
    return [
        subprocess.Popen(
            [sys.executable, script_path, *map(str, args)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
            start_new_session=True,
            env=_env({"RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
                      "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                      "MASTER_PORT": port}),
        )
        for r in range(world)
    ]


def start_torchrun(argv: Sequence[str], nproc: int) -> List[subprocess.Popen]:
    """``python -m torch.distributed.run --nproc-per-node nproc *argv``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()), *map(str, argv)]
    return [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, cwd=REPO, env=_env({}), start_new_session=True)]


def wait(procs: List[subprocess.Popen], timeout: float = WAIT_TIMEOUT_S) -> List[str]:
    """Wait for every process; kill them all (with what they started) and
    fail on a timeout or a non-zero exit, with the output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:  # each in its own session: torchrun's workers go too
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass  # that one had ended
        for p in procs:
            p.communicate()
        raise AssertionError(f"ranks still running after {timeout} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank exited {p.returncode}:\n{out[-4000:]}"
    return outs
