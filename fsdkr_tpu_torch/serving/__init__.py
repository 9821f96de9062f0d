"""Refresh-as-a-service, in one process: the RefreshService scheduler
(admission, per-session lifecycle, coalesced fused finalize launches,
retries, the deadline reaper), SLO-driven capacity planning for the
precompute pools, the batching, shedding and bisection policies, the
write-ahead journal with crash recovery, the fault plan, and the
`fsdkr_serving_*` and `fsdkr_ingress_*` telemetry, and its network and
fleet half: the asyncio TCP ingress (`ingress`: CRC-framed JSON,
backpressure, slow-loris sweeps, graceful drain, the per-peer rate
limiter, the network fault sites) and the shard supervisor
(`supervisor`: shard processes on the card, heartbeat, failover by
journal replay). An own copy of fsdkr_tpu/serving/.

The package orchestrates through `protocol`, `precompute`, `telemetry`
and `utils`; the cryptography stays behind the protocol surface.
"""

from .journal import Journal, JournalCorruption  # noqa: F401
from .planner import SLO, CapacityPlanner, serve_owner  # noqa: F401
from .policy import (  # noqa: F401
    BatchPolicy,
    BisectGuard,
    OverloadPolicy,
    PeerRateLimiter,
)
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
from .ingress import IngressClient, IngressServer  # noqa: F401
from .supervisor import ShardSupervisor, shard_for  # noqa: F401
from . import faults, ingress, journal, metrics, recovery, supervisor  # noqa: F401

__all__ = [
    "SLO",
    "CapacityPlanner",
    "serve_owner",
    "BatchPolicy",
    "OverloadPolicy",
    "BisectGuard",
    "PeerRateLimiter",
    "RefreshService",
    "ServeSession",
    "ServeRejected",
    "SessionTimeout",
    "Journal",
    "JournalCorruption",
    "MemoryKeystore",
    "RecoverySecretsUnavailable",
    "recover",
    "IngressServer",
    "IngressClient",
    "ShardSupervisor",
    "shard_for",
    "faults",
    "ingress",
    "journal",
    "metrics",
    "recovery",
    "supervisor",
]
