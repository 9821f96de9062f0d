"""Build and load the native host cores (csrc/fsdkr_native.cpp, the
bignum core, and csrc/fsdkr_ec.cpp, the secp256k1 core) with g++.

The library is compiled at first use into `build/` beside the package
(the directory the CUDA kernels build into), named by the source's hash
and this host's CPU features: it is built with -march=native, and a
library built under one feature set can fault under another. The build
writes a temporary file and renames it into place, so processes that
build at once never load a half-written library; threads of one process
wait on one lock, so it is compiled once.

There is no pure-Python path: a failed build or load raises. The JAX
package's loader falls back to CPython there, which would hide a
missing native core behind a prime search many times slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

__all__ = ["NativeBuildError", "NativeLib"]

_PKG = Path(__file__).resolve().parent.parent
_BUILD = _PKG / "build"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
# after the source: the bignum core resolves libgmp's mpn functions with
# dlopen, which glibc before 2.34 keeps in libdl
LD_LIBS = ["-ldl"]


class NativeBuildError(RuntimeError):
    """The native core did not build or did not load."""


def _cpu_feature_tag() -> str:
    """Hash of this host's CPU feature flags (the library is built with
    -march=native)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha256(feats.encode()).hexdigest()[:10]
    except OSError:
        pass
    return "nofeat"


class NativeLib:
    """Lazy, thread-safe loader of one C++ source: `get()` builds (once)
    and returns the ctypes library, each of `symbols` (name -> argtypes)
    given its argtypes and restype c_int, or raises NativeBuildError.
    `on_load(lib)`, if given, runs once on the loaded library before any
    caller sees it (and may raise NativeBuildError)."""

    def __init__(self, src: Path, symbols: Dict[str, Sequence],
                 on_load: Optional[Callable[[ctypes.CDLL], None]] = None):
        self._src = Path(src)
        self._symbols = dict(symbols)
        self._on_load = on_load
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def so_path(self) -> Path:
        text = self._src.read_bytes()
        flags = " ".join(CXX_FLAGS + LD_LIBS)
        tag = hashlib.sha256(text + flags.encode()).hexdigest()[:16]
        return _BUILD / (
            f"lib{self._src.stem}-{tag}-{platform.machine()}-{_cpu_feature_tag()}.so"
        )

    def _build(self) -> ctypes.CDLL:
        so = self.so_path()
        if not so.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(self._src),
                   *LD_LIBS]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                raise NativeBuildError(f"{cmd[0]} did not run on {self._src.name}: {e}") from e
            if proc.returncode != 0:
                try:
                    tmp.unlink()
                except OSError:
                    pass
                raise NativeBuildError(
                    f"{cmd[0]} failed on {self._src.name} ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, so)
        try:
            lib = ctypes.CDLL(str(so))
            for sym, argtypes in self._symbols.items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
        except (OSError, AttributeError) as e:
            raise NativeBuildError(f"cannot load {so.name}: {e}") from e
        if self._on_load is not None:
            self._on_load(lib)
        return lib

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    self._lib = self._build()
        return self._lib

    def loaded(self) -> bool:
        return self._lib is not None
