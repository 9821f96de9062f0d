"""Telemetry of the serving layer: the process-global labeled metrics
registry (`registry`: counters, gauges, fixed-bucket histograms with
interpolated p50/p95/p99, and their Prometheus text exposition) and the
always-on flight recorder (`flight`). An own copy of those two modules
of fsdkr_tpu/telemetry/; its spans and JSON export are not ported.

Secrecy rule: metric labels and flight-event fields accept allowlisted
small scalars only — never pool entries, rho coefficients, CRT contexts
or witness material. Wide integers are rejected at the API boundary.

The package imports neither torch nor the native core.
"""

from __future__ import annotations

from . import flight, registry  # noqa: F401
from .registry import (  # noqa: F401
    SCHEMA_VERSION,
    counter,
    gauge,
    get_registry,
    histogram,
    prometheus_text,
)

__all__ = [
    "SCHEMA_VERSION",
    "counter",
    "gauge",
    "histogram",
    "get_registry",
    "prometheus_text",
    "flight",
    "registry",
]
