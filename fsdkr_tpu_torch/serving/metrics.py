"""Serving telemetry: the `fsdkr_serving_*` and `fsdkr_ingress_*`
metric families (an own copy of fsdkr_tpu/serving/metrics.py).

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
    "ingress_connections",
    "ingress_open_gauge",
    "ingress_frames",
    "ingress_bytes",
    "ingress_rejected",
    "ingress_paused",
    "ingress_peer_shed",
    "ingress_snapshot",
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


# -- network ingress ---------------------------------------------------
# the fsdkr_ingress_* family: every byte/frame/shed decision the TCP
# ingress makes is countable from the registry, so a report or a
# Prometheus scrape can see a hostile peer or a backpressure stall
# without reading the server's logs. Labels are tiny cause/direction
# enums — never peer addresses (unbounded cardinality, and a peer list
# is operational data the metrics stream should not leak).


def ingress_connections():
    return registry.counter(
        "fsdkr_ingress_connections",
        "ingress TCP connections accepted, by how they ended "
        "(closed/error/shed/drained/faulted)",
        labelnames=("outcome",),
    )


def ingress_open_gauge():
    return registry.gauge(
        "fsdkr_ingress_open_connections",
        "ingress TCP connections currently open",
    )


def ingress_frames():
    return registry.counter(
        "fsdkr_ingress_frames",
        "wire frames processed, by direction (in/out)",
        labelnames=("direction",),
    )


def ingress_bytes():
    return registry.counter(
        "fsdkr_ingress_bytes",
        "wire bytes processed (frame headers included), by direction",
        labelnames=("direction",),
    )


def ingress_rejected():
    return registry.counter(
        "fsdkr_ingress_frames_rejected",
        "wire frames rejected, by cause (oversize/crc/malformed/"
        "bad_op/slow_read/slow_write/peer_rate/draining)",
        labelnames=("cause",),
    )


def ingress_paused():
    return registry.counter(
        "fsdkr_ingress_paused_reads",
        "TCP read pauses forced by the inflight byte budgets "
        "(connection-level or server-global backpressure)",
        labelnames=("scope",),
    )


def ingress_peer_shed():
    return registry.counter(
        "fsdkr_ingress_peer_rate_shed",
        "requests shed by the per-peer rate limiter",
    )


def ingress_snapshot() -> dict:
    """The ingress counter family as one plain dict (reports, the shard
    heartbeat). Reads through the registry so several servers in one
    process aggregate naturally."""
    out = {"connections": {}, "frames": {}, "bytes": {},
           "frames_rejected": {}, "paused_reads": {}}
    reg = registry.get_registry()
    for name, key, label in (
        ("fsdkr_ingress_connections", "connections", "outcome"),
        ("fsdkr_ingress_frames", "frames", "direction"),
        ("fsdkr_ingress_bytes", "bytes", "direction"),
        ("fsdkr_ingress_frames_rejected", "frames_rejected", "cause"),
        ("fsdkr_ingress_paused_reads", "paused_reads", "scope"),
    ):
        m = reg.get(name)
        if m is None:
            continue
        for rec in m.snapshot_values():
            out[key][rec["labels"].get(label, "?")] = int(rec["value"])
    m = reg.get("fsdkr_ingress_peer_rate_shed")
    out["peer_rate_shed"] = int(m.value()) if m is not None else 0
    m = reg.get("fsdkr_ingress_open_connections")
    vals = m.snapshot_values() if m is not None else []
    out["open_connections"] = int(vals[0]["value"]) if vals else 0
    return out


def rlc_bisect_count() -> int:
    """Lifetime RLC bisection fallbacks, read through the registry. The
    serving layer does not import `backend.rlc`, but the counter is shared
    process state: look it up by name, 0 when the verifier has not created
    it yet (no re-declaration here: a name or label drift in backend.rlc
    must not fork a parallel always-zero counter)."""
    m = registry.get_registry().get("fsdkr_rlc_events")
    if m is None:
        return 0
    try:
        return int(m.value(event="bisect_fallbacks"))
    except Exception:
        return 0
