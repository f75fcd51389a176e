"""ctypes binding for the port's native Kuzmin tokenizer
(``native/kuzmin_parser.cpp``, a copy of the reference's).

At first use ``g++`` builds the source with ``-O2 -std=c++17 -fPIC -shared`` into the
package's ``build/`` directory (listed in ``.gitignore``) as
``libtip_kuzmin_<digest>.so``; the digest covers the source and the flags,
so an edited source is never served by a stale build, and the build is
renamed into place whole, so processes that build at once do not collide.
Nothing here runs at import.

Unlike the reference's binding, nothing fails quietly: a compile error
raises with the compiler's output, a library that does not load raises,
and a parse error raises.  The only case without the native path is no
``g++`` on ``PATH``: :func:`compiler` returns None and
``data/kuzmin.py::load_kuzmin_tsv`` uses the Python parser and logs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "kuzmin_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Files parsed by the native tokenizer in this process: tests and
# chip_smoke.py read it to show that the native path ran.
parses = 0


def compiler() -> Optional[str]:
    """The C++ compiler the build uses, or None when there is none on PATH."""
    return shutil.which("g++")


def build() -> Path:
    """Compile the tokenizer unless a build of this exact source and these
    flags exists; returns the library path."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    lib_path = BUILD_DIR / f"libtip_kuzmin_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(f"no g++ on PATH to build the native Kuzmin tokenizer from {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native Kuzmin tokenizer failed ({res.returncode}): "
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded tokenizer (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))  # OSError if it does not load
            lib.tip_parse_kuzmin.restype = ctypes.c_void_p
            lib.tip_parse_kuzmin.argtypes = [
                ctypes.c_char_p, ctypes.c_double, ctypes.c_double, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.tip_result_n_rows.restype = ctypes.c_int64
            lib.tip_result_n_rows.argtypes = [ctypes.c_void_p]
            lib.tip_result_names.restype = ctypes.c_char_p
            lib.tip_result_names.argtypes = [ctypes.c_void_p]
            lib.tip_result_labels.restype = ctypes.POINTER(ctypes.c_int32)
            lib.tip_result_labels.argtypes = [ctypes.c_void_p]
            lib.tip_result_error.restype = ctypes.c_char_p
            lib.tip_result_error.argtypes = [ctypes.c_void_p]
            lib.tip_free.restype = None
            lib.tip_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def parse_kuzmin_file(path, cfg) -> List[Tuple[str, str, str, int]]:
    """The (gene_a, gene_b, gene_c, label) rows of a trigenic Kuzmin TSV,
    as ``data/kuzmin.py::parse_kuzmin_rows`` gives them.

    Raises FileNotFoundError for a missing file and ValueError (the Python
    parser's class) on missing columns.
    """
    global parses
    lib = library()
    path = os.fspath(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    handle = lib.tip_parse_kuzmin(
        path.encode(),
        float(cfg.p_cutoff),
        float(cfg.tau_cutoff),
        1 if cfg.tau_mode == "negative" else 0,
        (cfg.mutant_type or "").encode(),
        1 if cfg.strip_allele_suffix else 0,
        1 if cfg.deduplicate else 0,
    )
    if not handle:
        raise MemoryError(f"the native Kuzmin tokenizer could not allocate its result ({path})")
    try:
        err = lib.tip_result_error(handle)
        if err:
            raise ValueError(f"{err.decode()} ({path})")
        n = lib.tip_result_n_rows(handle)
        rows: List[Tuple[str, str, str, int]] = []
        if n:
            # One copy of the labels; a per-element ctypes loop would cost
            # hundreds of ms at Data S1 scale.
            labels = np.ctypeslib.as_array(lib.tip_result_labels(handle), shape=(n,)).copy()
            names = lib.tip_result_names(handle).decode().splitlines()
            if len(names) != n:
                raise RuntimeError(f"native tokenizer returned {len(names)} names for {n} rows")
            for line, lab in zip(names, labels.tolist()):
                a, b, c = line.split("\t")
                rows.append((a, b, c, lab))
    finally:
        lib.tip_free(handle)
    parses += 1
    return rows
