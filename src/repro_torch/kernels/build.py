"""Build a CUDA C++ source of the port into a shared library and load it.

Route: ``nvcc`` by hand into a ``.so`` with a plain C interface, loaded with
``ctypes`` (seconds to build, where a source including PyTorch's headers
takes minutes).  The build runs at first use, never at import, into
``kernels/_build/`` beside the sources (listed in ``.gitignore``).  The
library's file name carries a hash of the source, the headers beside it
and the flags, so an edited source or header is rebuilt and a stale library
is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # build time (0.0 when an up-to-date library was reused)
    log: str  # nvcc's output, including -Xptxas -v register/smem report


_lock = threading.Lock()  # guards _source_locks
_source_locks: Dict[str, threading.Lock] = {}  # one per source: sources build in parallel
_loaded: Dict[str, Built] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")
    return found


def load_cuda_library(name: str, source: Path) -> Built:
    """Compile ``source`` for sm_90a and return the loaded library; the first
    call of a process does the work, later calls are a dict lookup (the
    wrappers call this on every launch).  Different sources build in
    parallel when called from several threads.  Raises with nvcc's output
    if the build fails."""
    key = str(Path(source))
    with _lock:
        lock = _source_locks.setdefault(key, threading.Lock())
    with lock:
        built = _loaded.get(key)
        if built is None:
            built = _loaded[key] = _build(name, Path(source))
        return built


def _build(name: str, source: Path) -> Built:
    flags = ARCH_FLAGS + NVCC_FLAGS
    # the source, the headers beside it (which it may include) and the flags
    text = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.monotonic()
        try:
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", tmp, str(source)],
                capture_output=True, text=True, check=False,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source}:\n{log}")
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.monotonic() - t0
    return Built(ctypes.CDLL(str(path)), path, seconds, log)
