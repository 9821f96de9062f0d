"""Refresh-as-a-service, in one process: the RefreshService scheduler
(admission, per-session lifecycle, coalesced fused finalize launches,
retries, the deadline reaper), SLO-driven capacity planning for the
precompute pools, the batching, shedding and bisection policies, the
write-ahead journal with crash recovery, the fault plan, and the
`fsdkr_serving_*` telemetry. An own copy of fsdkr_tpu/serving/; its TCP
ingress, per-peer rate limiter and shard supervisor are not ported yet.

The package orchestrates through `protocol`, `precompute`, `telemetry`
and `utils`; the cryptography stays behind the protocol surface.
"""

from .journal import Journal, JournalCorruption  # noqa: F401
from .planner import SLO, CapacityPlanner, serve_owner  # noqa: F401
from .policy import BatchPolicy, BisectGuard, OverloadPolicy  # noqa: F401
from .recovery import (  # noqa: F401
    MemoryKeystore,
    RecoverySecretsUnavailable,
    recover,
)
from .service import (  # noqa: F401
    RefreshService,
    ServeRejected,
    ServeSession,
    SessionTimeout,
)
from . import faults, journal, metrics, recovery  # noqa: F401

__all__ = [
    "SLO",
    "CapacityPlanner",
    "serve_owner",
    "BatchPolicy",
    "OverloadPolicy",
    "BisectGuard",
    "RefreshService",
    "ServeSession",
    "ServeRejected",
    "SessionTimeout",
    "Journal",
    "JournalCorruption",
    "MemoryKeystore",
    "RecoverySecretsUnavailable",
    "recover",
    "faults",
    "journal",
    "metrics",
    "recovery",
]
