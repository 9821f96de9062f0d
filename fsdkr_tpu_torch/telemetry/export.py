"""Telemetry export: the schema-versioned JSON snapshot and the
Prometheus text exposition, to a string or a file (an own copy of
fsdkr_tpu/telemetry/export.py).

The JSON snapshot IS `registry.Registry.snapshot()` — one schema, one
read path. `prometheus_text` is the registry's own (text format v0.0.4:
counters get a `_total`-suffixed sample when the name does not already
carry one, histograms emit cumulative `_bucket{le=...}` samples plus
`_sum` and `_count`, function gauges are evaluated at dump time).
`dump_metrics(path)` writes it to an explicit path (the JAX package
also dumps to FSDKR_METRICS_DUMP at exit; the port reads no
environment).
"""

from __future__ import annotations

import os

from .registry import SCHEMA_VERSION, get_registry, prometheus_text

__all__ = [
    "SCHEMA_VERSION",
    "snapshot",
    "prometheus_text",
    "dump_metrics",
]


def snapshot() -> dict:
    """The one structured telemetry read (schema-versioned)."""
    return get_registry().snapshot()


def dump_metrics(path) -> str:
    """Write the Prometheus exposition to `path` (atomic replace)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(prometheus_text())
    os.replace(tmp, path)
    return str(path)
