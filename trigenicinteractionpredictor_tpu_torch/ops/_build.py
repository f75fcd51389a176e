"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use, one ``nvcc`` per source, all started together, compiles
every source for Hopper (``sm_90a``) into an object file; one more links
them into a shared library with a plain C interface in the package's
``build/`` directory (listed in ``.gitignore``); ``ctypes`` loads it.  The
library name carries a digest of the sources, the headers they include
(``csrc/*.cuh``) and the flags, so an edited source is never served by a
stale build.  Nothing here runs at import.

Each C entry takes device pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()``; :func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # theta, p, trip, rat, w, streams (or null), part,
    # S, B, G, K, R, tile, rows_per_block, threads, smem_bytes, stream
    "tip_em_sweep": [_P] * 7 + [_I] * 9 + [_P],
    # theta, p, trip, w, order, off, pk, streams, p_part, ll_part, scale, rowinfo,
    # S, B, G, K, R, KC, estep_threads, estep_smem, nk, splits, vec,
    # cross_threads, cross_smem, stream
    "tip_em_sweep_large_k": [_P] * 12 + [_I] * 13 + [_P],
    # th1, th2, th3, then as tip_em_sweep_large_k from p
    "tip_em_hybrid": [_P] * 14 + [_I] * 13 + [_P],
    # theta, p, trip, packed p, out, S, B, G, K, R, ir, KLP, wkl, wr, smem_bytes, stream
    "tip_score": [_P] * 5 + [_I] * 10 + [_P],
    # theta, p, trip, rat, w, g1_lid, g1_off, streams, theta_hat, part_th, part_p,
    # S, B, G, K, R, Q1, wb1, tile, piece_rows, threads, smem_bytes, stream
    "tip_em_bdg": [_P] * 11 + [_I] * 11 + [_P],
    # vals, perm, lid, off, out, part, edge,
    # L, Q, wb, SK, K, G, piece, vec, blocks, smem_bytes, stream
    "tip_plan_scatter": [_P] * 7 + [_I] * 10 + [_P],
    # theta, p, trip, tile_r, w, part,
    # S, B, G, K, R, tile, tile_b, rows_per_block, threads, smem_bytes, stream
    "tip_em_rsorted": [_P] * 6 + [_I] * 10 + [_P],
    # three segments of (part, out, nb, ld, c), S, stream
    "tip_block_sum": ([_P] * 2 + [_I] * 3) * 3 + [_I, _P],
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's CUDA "
        "kernels are built from csrc/ at first use"
    )


def build() -> Path:
    """Compile csrc/*.cu into build/ unless a build of these exact sources
    exists; returns the library path.  Records the build seconds and the
    ptxas report (registers, shared memory, spills) in ``build_info``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libtip_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return lib_path
    obj_dir = BUILD_DIR / f"obj_{digest.hexdigest()[:16]}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    reports = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
    for cmd, out, rc in reports:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({res.returncode}): {' '.join(link)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    build_info.update(
        seconds=time.perf_counter() - t0,
        cached=False,
        ptxas="\n".join(out.strip() for _, out, _ in reports),
    )
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` -- what a kernel's raw pointer arguments assume."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)}; "
            f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
