"""Build a kernel source of `csrc/` into a shared library with nvcc.

Route (b) of the port's kernels: a plain C interface, compiled for
sm_90a into `build/` beside the package at first use and loaded with
ctypes by the module that binds it. The library's name carries a hash of
the source and the flags, so an edited source is rebuilt. Nothing is
built at import. Builds of different sources may run at the same time
(each compiles into its own temporary file, named by process and
thread); threads that ask for the same library wait on one lock, so it
is compiled once.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "build_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


_LOCKS: dict = {}  # library path -> the lock its build is taken under
_LOCKS_GUARD = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def build_library(src: Path) -> dict:
    """Compile `src` unless its library exists: {"so": path, "seconds":
    build or lookup time, "ptxas": nvcc's -Xptxas -v report (on a
    build)}."""
    text = src.read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD / f"lib{src.stem}-{tag}.so"
    info = {}
    t0 = time.perf_counter()
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(so, threading.Lock())
    with lock:
        if not so.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, so)
            info["ptxas"] = proc.stderr
    info["seconds"] = time.perf_counter() - t0
    info["so"] = str(so)
    return info
