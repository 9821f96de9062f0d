"""Serving telemetry: the `fsdkr_serving_*` metric family (an own copy
of fsdkr_tpu/serving/metrics.py; its `fsdkr_ingress_*` family comes
with the ingress).

All metrics live in the process-global telemetry registry
(`telemetry.registry`), so they ride the same snapshot and Prometheus
exposition as every other subsystem. Labels carry tiny enums only
(lifecycle phase, outcome) — never committee identifiers (unbounded
cardinality) and never anything derived from key material.
"""

from __future__ import annotations

from ..telemetry import registry

__all__ = [
    "sessions_counter",
    "phase_histogram",
    "batch_histogram",
    "inflight_gauge",
    "queue_gauge",
    "committees_gauge",
    "record_phase",
    "record_outcome",
    "rlc_bisect_count",
    "retries_counter",
]

# end-to-end latencies span ~10 ms smoke sessions to minutes under
# overload; log-spaced buckets keep the interpolated p99 honest at both
# ends without per-sample retention
_SECONDS_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0,
    40.0, 80.0, 160.0, 320.0,
)


def sessions_counter():
    return registry.counter(
        "fsdkr_serving_sessions",
        "refresh sessions finished, by outcome "
        "(done/aborted/timed_out/rejected)",
        labelnames=("outcome",),
    )


def retries_counter():
    return registry.counter(
        "fsdkr_serving_retries",
        "transient-failure retries, by stage (worker/finalize)",
        labelnames=("stage",),
    )


def phase_histogram():
    return registry.histogram(
        "fsdkr_serving_phase_seconds",
        "per-session lifecycle phase latency "
        "(queue/distribute/stream/coalesce/finalize/total)",
        labelnames=("phase",),
        buckets=_SECONDS_BUCKETS,
    )


def batch_histogram():
    return registry.histogram(
        "fsdkr_serving_batch_sessions",
        "collector sessions fused per finalize launch",
        buckets=(1, 2, 4, 8, 16, 32, 64, 128),
    )


def inflight_gauge():
    return registry.gauge(
        "fsdkr_serving_inflight",
        "sessions admitted but not yet done/aborted",
    )


def queue_gauge():
    return registry.gauge(
        "fsdkr_serving_queue_depth",
        "sessions waiting in the admission queue (public metadata only)",
    )


def committees_gauge():
    return registry.gauge(
        "fsdkr_serving_committees",
        "committees currently admitted to the service",
    )


def record_phase(phase: str, seconds: float) -> None:
    phase_histogram().observe(seconds, phase=phase)


def record_outcome(outcome: str, total_seconds: float) -> None:
    sessions_counter().inc(outcome=outcome)
    # a rejected submission never became a session: no latency sample
    if outcome != "rejected":
        phase_histogram().observe(total_seconds, phase="total")


def rlc_bisect_count() -> int:
    """Lifetime RLC bisection fallbacks: the verifier's
    `backend.rlc.stats()` counter (the JAX package reads the same event
    from its registry; the port's verifier keeps a module-level dict)."""
    from ..backend import rlc

    return int(rlc.stats()["bisect_fallbacks"])
