"""Telemetry of the serving layer: the process-global labeled metrics
registry (`registry`: counters, gauges, fixed-bucket histograms with
interpolated p50/p95/p99, and their Prometheus text exposition), the
JSON snapshot and the exposition written to a file (`export`), and the
always-on flight recorder with its postmortem dump (`flight`), and the
span tracer (`spans`: `get_tracer()`, `phase(...)`, the Chrome-trace
export, `torch_profile`). An own copy of fsdkr_tpu/telemetry/. Every
destination is an explicit path: the package reads no environment and
installs no hook at import; tracing is off until a caller enables it,
and a caller that wants the trace writes it
(`get_tracer().write_chrome_trace(path)`).

Secrecy rule: metric labels and flight-event fields accept allowlisted
small scalars only — never pool entries, rho coefficients, CRT contexts
or witness material. Wide integers are rejected at the API boundary.

The package imports neither torch (`torch_profile` imports it when
called) nor the native core.
"""

from __future__ import annotations

from . import export, flight, registry, spans  # noqa: F401
from .registry import (  # noqa: F401
    SCHEMA_VERSION,
    counter,
    gauge,
    get_registry,
    histogram,
    prometheus_text,
)
from .spans import (  # noqa: F401
    PhaseStats,
    Span,
    Tracer,
    get_tracer,
    phase,
    torch_profile,
)

__all__ = [
    "SCHEMA_VERSION",
    "PhaseStats",
    "Span",
    "Tracer",
    "get_tracer",
    "phase",
    "torch_profile",
    "counter",
    "gauge",
    "histogram",
    "get_registry",
    "prometheus_text",
    "export",
    "flight",
    "registry",
    "spans",
]
