"""The PyTorch port imports torch and numpy, never jax, and nothing of
the JAX package (not even its JAX-free modules: the port keeps its own
copies). Checked in a subprocess — tests/conftest.py imports jax into
this one — and by a static scan of the sources and chip_smoke.py.
"""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "fsdkr_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
import fsdkr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    fsdkr_tpu_torch.__path__, "fsdkr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "fsdkr_tpu" or m.startswith("fsdkr_tpu."))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_import_loads_no_jax_and_no_reference_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=str(REPO),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count, bad = proc.stdout.split(maxsplit=1)
    assert bad.strip() == "[]"
    assert int(count) >= 20  # every submodule was imported


def _sources():
    files = (sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
             + sorted(PORT.rglob("*.cpp")))
    return files + [REPO / "chip_smoke.py"]


# `fsdkr_tpu` as a whole word, except as a path into the repository
# ("fsdkr_tpu/ops/pallas_rns.py:184" in a note of which TPU kernel a
# Hopper kernel replaces): a module reference, an import or a module
# name in a string is refused. `fsdkr_tpu_torch` is another word.
_REFERENCE = re.compile(r"\bfsdkr_tpu\b(?!/)")
_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b", re.M)


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(REPO))
)
def test_source_names_no_reference_module(path):
    text = path.read_text()
    hits = [m.group(0) for m in _REFERENCE.finditer(text)]
    assert not hits, f"{path}: names the JAX package as a module"
    assert not _JAX_IMPORT.search(text), f"{path}: imports jax"


def test_scan_sees_the_whole_package():
    mods = {m.name for m in pkgutil.walk_packages([str(PORT)])}
    assert {"ops", "backend", "protocol", "carry", "native", "precompute", "serving",
            "telemetry"} <= mods
    sources = _sources()
    assert (PORT / "csrc" / "rns_kernels.cu") in sources
    assert (PORT / "csrc" / "fsdkr_native.cpp") in sources
    for part in ("native/__init__.py", "native/_loader.py", "backend/crt.py",
                 "precompute/__init__.py", "precompute/pools.py",
                 "precompute/producer.py", "serving/service.py", "serving/recovery.py",
                 "serving/journal.py", "telemetry/registry.py", "telemetry/flight.py"):
        assert PORT / part in sources
