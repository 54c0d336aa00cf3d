"""Build a kernel's CUDA sources into a shared library at first use.

The sources under a kernel's ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into a plain-C shared library, loaded with `ctypes`.  The
library lands in ``kernels/_build/`` (git-ignored), named by a hash of the
sources, the headers (``*.cuh``) beside them and the flags, so a changed
source or header is rebuilt and an unchanged one is reused.  A failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_log", "find_nvcc", "load_library"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the build log
)

_LOCK = threading.Lock()  # guards _NAME_LOCKS
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(sources: Sequence[Path]) -> str:
    """The flags, the sources and the headers (``*.cuh``) beside them."""
    headers = sorted({hdr for src in sources for hdr in src.parent.glob("*.cuh")})
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *headers]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>`` from ``sources``.  Different
    libraries build concurrently when loaded from several threads."""
    sources = [Path(s) for s in sources]
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LOADED:
            return _LOADED[name]
        so = BUILD_DIR / f"lib{name}-{_digest(sources)}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed building {name} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            so.with_suffix(".log").write_text(
                f"{' '.join(cmd)}\nbuilt in {seconds:.2f} s\n{proc.stdout}{proc.stderr}"
            )
            os.replace(tmp, so)
        _LOGS[name] = so.with_suffix(".log").read_text() if so.with_suffix(".log").exists() else ""
        _LOADED[name] = ctypes.CDLL(str(so))
        return _LOADED[name]


def build_log(name: str) -> str:
    """The nvcc command and its output for a library loaded in this process."""
    return _LOGS.get(name, "")
