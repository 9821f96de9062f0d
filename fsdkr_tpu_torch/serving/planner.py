"""SLO-driven capacity planning for the precompute pools (an own copy of
fsdkr_tpu/serving/planner.py).

A serving loop needs per-committee pool depth targets derived from the
committee's SLO (expected arrival rate, p99 latency budget), so the
pools hold enough single-use material to absorb bursts without dry
fallbacks, and are retargeted/invalidated when the committee's key
material rotates (every epoch) or churns (eviction).

The planner does not produce anything itself: it translates SLOs into
`precompute.retarget_committee` calls under the committee's serving
owner tag, which the background producer fills and the committee's
next distribute claims (`precompute.claim`). Depth math, shaped by
which pools survive an epoch:

- enc/pdl/alice are keyed by receiver Paillier moduli, which refresh
  ROTATES every epoch — any depth beyond one epoch of consumption
  (`new_n` entries per pool) is guaranteed wipe-waste, so the planner
  always asks for exactly one epoch there.
- the config-keyed "keys" pool is epoch-stable and SHARED by every
  committee with that config, so it alone absorbs the SLO runway:
  want = clamp(ceil(sum of arrival rates * horizon), 1, max_ahead *
  committees) * new_n, registered under the fleet-wide KEYS_POOL_OWNER.

Entry depth is still capped by the pool store's POOL_DEPTH and
POOL_BUDGET_BYTES — the planner asks, the store enforces.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict

from .. import precompute
from ..telemetry import registry

__all__ = ["SLO", "CapacityPlanner", "serve_owner"]


@dataclass(frozen=True)
class SLO:
    """Per-committee service-level objective. `arrival_rate_hz` is the
    expected refresh-request rate for this committee; `p99_budget_s` the
    end-to-end latency budget the operator wants honored (reported
    against the measured p99; the planner's depth math uses the rate)."""

    arrival_rate_hz: float = 0.05
    p99_budget_s: float = 30.0


def serve_owner(committee_id) -> tuple:
    """The precompute owner tag of one admitted committee. Distinct from
    the mod-N~ fingerprint `precompute.committee_owner` so that cloned /
    re-admitted committees sharing auxiliary parameters stay separately
    invalidatable; the service's distribute claims under it
    (`precompute.owner_scope`)."""
    return ("serve", committee_id)


class CapacityPlanner:
    """Registry of admitted committees' SLOs + the retarget engine."""

    def __init__(self, horizon_s: float = 30.0, max_ahead: int = 4):
        # the JAX package's FSDKR_SERVE_HORIZON_S and FSDKR_SERVE_MAX_AHEAD
        # defaults
        self.horizon_s = horizon_s
        self.max_ahead = max_ahead
        self._lock = threading.Lock()
        # committee_id -> (representative LocalKey, new_n, config, slo);
        # the LocalKey is the live object the service mutates in place,
        # so retarget() always sees the CURRENT paillier_key_vec
        self._committees: Dict[object, tuple] = {}
        registry.gauge(
            "fsdkr_serving_planned_ahead",
            "mean epochs-ahead depth target across admitted committees",
        ).set_function(self._mean_ahead)

    # ------------------------------------------------------------------
    def epochs_ahead(self, slo: SLO) -> int:
        return max(
            1, min(self.max_ahead, math.ceil(slo.arrival_rate_hz * self.horizon_s))
        )

    def _mean_ahead(self) -> float:
        with self._lock:
            items = list(self._committees.values())
        if not items:
            return 0.0
        return sum(self.epochs_ahead(slo) for _k, _n, _c, slo in items) / len(items)

    # ------------------------------------------------------------------
    def register(self, committee_id, local_key, new_n: int, config, slo: SLO) -> None:
        """Admit a committee: record its SLO and install its initial
        pool targets (keyed by the CURRENT paillier_key_vec)."""
        with self._lock:
            self._committees[committee_id] = (local_key, new_n, config, slo)
        self.retarget(committee_id)

    def keys_want(self, config) -> int:
        """Fleet-wide key-material demand for this config: sessions
        expected over the horizon across every admitted committee
        sharing the config's pool key, times bundles per session."""
        kp = config.key_material_pool_key
        with self._lock:
            peers = [
                (n, slo)
                for _k, n, c, slo in self._committees.values()
                if c.key_material_pool_key == kp
            ]
        if not peers:
            return 1
        new_n = peers[0][0]
        rate = sum(slo.arrival_rate_hz for _n, slo in peers)
        sessions = max(1, min(
            self.max_ahead * len(peers), math.ceil(rate * self.horizon_s)
        ))
        return sessions * new_n

    def retarget(self, committee_id) -> None:
        """Re-derive this committee's pool targets from its live key
        state — called after every completed epoch (the eks just
        rotated) and after churn. Stale-keyed targets and their pooled
        secrets are wiped by retarget_committee (wipe-on-invalidate)."""
        with self._lock:
            ent = self._committees.get(committee_id)
        if ent is None:
            return
        local_key, new_n, config, slo = ent
        precompute.retarget_committee(
            local_key, new_n, new_n, config,
            owner=serve_owner(committee_id),
            keys_want=self.keys_want(config),
        )

    def invalidate(self, committee_id) -> int:
        """Committee eviction / churn: drop every target registered
        under its owner and wipe the pooled entries now."""
        with self._lock:
            self._committees.pop(committee_id, None)
        return precompute.invalidate_owner(serve_owner(committee_id))
