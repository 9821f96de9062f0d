"""The PyTorch port imports torch and numpy, never jax, and nothing of
the JAX package (not even its JAX-free modules: the port keeps its own
copies). Checked in a subprocess — tests/conftest.py imports jax into
this one — and by a static scan of the sources and chip_smoke.py. The
serving, telemetry and precompute layers, the roofline and the load
generator read no environment variable: their knobs are arguments (the
JAX package's FSDKR_* variables), and so does the host bignum layer
(the GMP bridge, native EC, intops, the prime pipeline: no FSDKR_GMP,
FSDKR_THREADS, FSDKR_NATIVE_EC or FSDKR_NATIVE_POW). The serving layer
imports nothing of the backend: it reads the verifier's counters from
the registry.
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
    assert (PORT / "csrc" / "fsdkr_ec.cpp") in sources
    for part in ("native/__init__.py", "native/_loader.py", "native/gmp.py", "native/ec.py",
                 "backend/crt.py",
                 "precompute/__init__.py", "precompute/pools.py",
                 "precompute/producer.py", "serving/service.py", "serving/recovery.py",
                 "serving/journal.py", "telemetry/registry.py", "telemetry/flight.py",
                 "serving/ingress.py", "serving/supervisor.py", "serving/policy.py",
                 "telemetry/export.py", "telemetry/spans.py", "utils/roofline.py",
                 "serving/loadgen.py"):
        assert PORT / part in sources


_ENV_READ = re.compile(r"\bos\.environ\b|\bgetenv\s*\(|\benviron\s*[\[.]|\bputenv\s*\(")
_ENV_FREE = ("serving", "telemetry", "precompute")


@pytest.mark.parametrize("layer", _ENV_FREE)
def test_layer_reads_no_environment(layer):
    files = sorted((PORT / layer).rglob("*.py"))
    assert len(files) >= 3
    hits = [f"{p.relative_to(REPO)}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if _ENV_READ.search(line)]
    assert not hits, hits


@pytest.mark.parametrize("part", ["telemetry/spans.py", "utils/roofline.py",
                                  "serving/loadgen.py"])
def test_tracer_roofline_and_loadgen_read_no_environment(part):
    text = (PORT / part).read_text()
    hits = [i for i, line in enumerate(text.splitlines(), 1) if _ENV_READ.search(line)]
    assert not hits, (part, hits)


@pytest.mark.parametrize("part", ["native/gmp.py", "native/ec.py", "native/__init__.py",
                                  "core/intops.py", "core/primes.py"])
def test_host_bignum_layer_reads_no_environment(part):
    text = (PORT / part).read_text()
    hits = [i for i, line in enumerate(text.splitlines(), 1) if _ENV_READ.search(line)]
    assert not hits, (part, hits)


_BACKEND_IMPORT = re.compile(
    r"^\s*(from\s+(\.\.|fsdkr_tpu_torch\.)backend\b|import\s+fsdkr_tpu_torch\.backend\b"
    r"|from\s+(\.\.|fsdkr_tpu_torch)\s+import\s+(.*,\s*)?backend\b)", re.M)


def test_serving_imports_nothing_of_the_backend():
    files = sorted((PORT / "serving").rglob("*.py"))
    assert PORT / "serving" / "metrics.py" in files
    hits = [str(p.relative_to(REPO)) for p in files if _BACKEND_IMPORT.search(p.read_text())]
    assert not hits, hits
    # the pattern sees the forms it refuses
    for form in ("from ..backend import rlc", "    from ..backend.rlc import stats",
                 "import fsdkr_tpu_torch.backend.rlc", "from .. import precompute, backend"):
        assert _BACKEND_IMPORT.search(form), form


def test_new_serving_modules_have_the_jax_packages_public_names():
    import importlib

    for mod, names in (
        ("serving.ingress", ("FRAME_HEADER", "FrameError", "encode_frame", "IngressServer",
                             "IngressClient")),
        ("serving.supervisor", ("ShardSupervisor", "ShardHandle", "shard_for")),
        ("telemetry.export", ("SCHEMA_VERSION", "snapshot", "prometheus_text",
                              "dump_metrics")),
        ("telemetry.flight", ("FlightRecorder", "get_flight", "record", "dump", "install",
                              "FLIGHT_SCHEMA")),
        ("serving.policy", ("PeerRateLimiter",)),
        ("telemetry.spans", ("PhaseStats", "Span", "Tracer", "get_tracer", "phase")),
        ("utils.roofline", ("montmul_macs", "generic_modexp_macs", "shared_modexp_macs",
                            "modmul_macs", "k16", "stamp_generic_host", "stamp_shared_host")),
        ("serving.loadgen", ("run_window", "collect_sessions", "classify_chaos",
                             "run_tamper_curve", "run_crash_storm", "run_net_storm",
                             "run_net_client", "main")),
        ("native.gmp", ("powm", "powm_batch", "gcd", "PublicOperand")),
        ("native.ec", ("horner_batch", "lincomb2_batch")),
        ("native", ("engine_kind", "thread_count")),
    ):
        m = importlib.import_module(f"fsdkr_tpu_torch.{mod}")
        assert set(names) <= set(m.__all__), mod
        for name in names:
            assert hasattr(m, name), (mod, name)
