"""The kernels' first-use build is thread-safe: threads that reach a
kernel first at the same time compile its source once and load its
library once (`ops.nvcc_build.build_library`, each kernel module's
`load_library`). Runs on the CPU with a fake compiler (`subprocess.run`
replaced by one that writes its output file after a pause) and a fake
loader (`ctypes.CDLL`), counting their calls.
"""

import ctypes
import os
import subprocess
import threading
import time
from unittest import mock

import pytest

from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, nvcc_build, rns_kernels

THREADS = 2


@pytest.fixture
def fake_toolchain(monkeypatch, tmp_path):
    """nvcc_build's build directory in tmp_path; (compiles, loads): the
    (-o path, thread) of each call of the fake compiler, the paths
    loaded."""
    compiles, loads = [], []
    lock = threading.Lock()

    def fake_run(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        with lock:
            compiles.append((out, threading.get_ident()))
        time.sleep(0.2)  # the window in which a second thread would race
        with open(out, "wb") as f:
            f.write(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    def fake_cdll(path):
        with lock:
            loads.append(path)
        return mock.MagicMock(name=f"CDLL({path})")

    monkeypatch.setattr(nvcc_build, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(nvcc_build.subprocess, "run", fake_run)
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    return compiles, loads


def _together(fn):
    """fn() on THREADS threads released at once; their results in order."""
    start = threading.Barrier(THREADS)
    results = [None] * THREADS
    errors = []

    def run(k):
        start.wait()
        try:
            results[k] = fn()
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def test_build_library_compiles_once_across_threads(fake_toolchain, tmp_path):
    compiles, _ = fake_toolchain
    src = tmp_path / "probe_kernels.cu"
    src.write_text("extern \"C\" int probe() { return 0; }\n")
    infos = _together(lambda: nvcc_build.build_library(src))
    assert len(compiles) == 1
    # the temporary file is named by process and thread
    (out, thread), = compiles
    assert out.endswith(f".{os.getpid()}.{thread}.tmp")
    assert infos[0]["so"] == infos[1]["so"]
    assert sum("ptxas" in info for info in infos) == 1  # the other found the library built
    assert nvcc_build.build_library(src)["so"] == infos[0]["so"] and len(compiles) == 1


@pytest.mark.parametrize("mod", [montgomery_kernels, ec_kernels, rns_kernels],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_load_library_builds_and_loads_once_across_threads(fake_toolchain, monkeypatch, mod):
    compiles, loads = fake_toolchain
    monkeypatch.setattr(mod, "_LIB", None)
    monkeypatch.setattr(mod, "build_info", {})
    libs = _together(mod.load_library)
    assert len(compiles) == 1 and len(loads) == 1
    assert libs[0] is libs[1] is mod._LIB
    assert mod.load_library() is libs[0] and len(loads) == 1
    assert mod.build_info["so"] == loads[0]
