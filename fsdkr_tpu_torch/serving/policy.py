"""Serving policies: finalize batching, admission overload shedding,
and the bisection-storm guard (an own copy of
fsdkr_tpu/serving/policy.py; its `PeerRateLimiter` comes with the
ingress, its only caller). Every threshold is a constructor argument at
the JAX package's default; the port reads no environment.

`BatchPolicy` — quorum-ready streaming sessions are fused into one
`finalize_streams` launch; the policy decides WHEN to launch and HOW
MANY sessions to take. Size-or-linger batching: launch immediately once
`max_sessions` collector streams are ready (JAX: FSDKR_SERVE_BATCH,
16), otherwise wait up to `linger_s` from the oldest ready session
(FSDKR_SERVE_LINGER_MS, 50 ms) before launching whatever is there —
throughput from fusion without unbounded latency. With `devices` > 1
the policy prefers batch sizes whose total row count divides the
device count; on one card that is a no-op.

`OverloadPolicy` — graceful degradation at admission: `submit()` is
rejected with a retry-after hint when the admission queue is past
`max_queue` (FSDKR_SERVE_MAX_QUEUE) or the measured end-to-end p99
exceeds `shed_p99_factor` (FSDKR_SERVE_SHED_P99) x the committee's SLO
budget. Both default off (0).

`BisectGuard` — per-committee budget on RLC bisection work per sliding
window. Honest transcripts bisect ZERO times, so bisections are an
attributable cost of tampered traffic; a committee whose sessions
forced more than `budget` (FSDKR_SERVE_BISECT_BUDGET) bisection
fallbacks inside `window_s` (FSDKR_SERVE_BISECT_WINDOW_S, 60 s) is shed
at admission until the window rolls. Default off (budget 0).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

__all__ = ["BatchPolicy", "OverloadPolicy", "BisectGuard"]


def _align_session_batch(count: int, rows_per_session: int, n_dev: int) -> int:
    """Largest batch size <= `count` whose total row count divides evenly
    across `n_dev` devices; `count` unchanged when none does."""
    for k in range(count, 0, -1):
        if (k * rows_per_session) % n_dev == 0:
            return k
    return count


class BatchPolicy:
    """Size-or-linger coalescing. `max_sessions` counts collector
    streams (one committee refresh with n collecting parties contributes
    n of them)."""

    def __init__(
        self,
        max_sessions: int = 16,
        linger_s: float = 0.05,
        devices: int = 1,
    ):
        self.max_sessions = max(1, max_sessions)
        self.linger_s = max(0.0, linger_s)
        self.devices = max(1, devices)

    def take(
        self, ready: int, oldest_wait_s: float, rows_per_session: int = 0
    ) -> int:
        """How many ready sessions to fuse into a launch right now;
        0 = keep lingering. Never returns more than `ready`."""
        if ready <= 0:
            return 0
        if ready < self.max_sessions and oldest_wait_s < self.linger_s:
            return 0
        count = min(ready, self.max_sessions)
        if self.devices > 1 and rows_per_session > 0:
            count = _align_session_batch(count, rows_per_session, self.devices)
        return count

    def wait_budget(self, oldest_wait_s: float) -> float:
        """Seconds the launcher may sleep before the linger deadline of
        the oldest ready session expires."""
        return max(0.0, self.linger_s - oldest_wait_s)


class OverloadPolicy:
    """Admission-time shedding. `check()` returns None (admit) or a
    retry-after hint in seconds (reject). Both gates default off (0)."""

    def __init__(self, max_queue: int = 0, shed_p99_factor: float = 0.0):
        self.max_queue = max_queue
        self.shed_p99_factor = shed_p99_factor

    def engaged(self) -> bool:
        """False when both gates are off (the default) — the caller can
        then skip computing the measured p99 entirely, keeping the
        submit hot path free of histogram scans under the service
        lock."""
        return self.max_queue > 0 or self.shed_p99_factor > 0

    def check(
        self,
        queue_depth: int,
        measured_p99_s: float,
        p99_budget_s: float,
    ) -> Optional[float]:
        """None = admit. A float = reject, retry after that many
        seconds. The hint is honest but cheap: the measured p99 itself
        (the time by which the backlog that caused the shed has very
        likely cleared), floored at 100 ms."""
        if self.max_queue > 0 and queue_depth >= self.max_queue:
            return max(0.1, measured_p99_s)
        if (
            self.shed_p99_factor > 0
            and p99_budget_s > 0
            and measured_p99_s > self.shed_p99_factor * p99_budget_s
        ):
            return max(0.1, measured_p99_s)
        return None


class BisectGuard:
    """Sliding-window per-committee budget on RLC bisection fallbacks.
    `charge(committee, n)` records bisection work attributed to the
    committee; `blocked(committee)` returns the seconds until its
    window has room again, or None while it is under budget. Committees
    never forced a bisection (every honest committee) are never
    touched. Budget 0 disables the guard entirely."""

    def __init__(self, budget: int = 0, window_s: float = 60.0):
        self.budget = budget
        self.window_s = window_s
        self._events: Dict[object, deque] = {}
        # charged by the launcher thread, read by submit() under the
        # service lock — the guard carries its own lock
        self._lock = threading.Lock()

    def enabled(self) -> bool:
        return self.budget > 0

    def _prune(self, q: deque, now: float) -> None:
        while q and now - q[0][0] > self.window_s:
            q.popleft()

    def reset(self) -> None:
        """Forget all charges (measurement-phase boundaries: a tamper
        curve must not inherit the previous window's blocks)."""
        with self._lock:
            self._events.clear()

    def charge(self, committee_id, n: int, now: Optional[float] = None) -> None:
        if not self.enabled() or n <= 0:
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            q = self._events.setdefault(committee_id, deque())
            self._prune(q, now)
            q.append((now, int(n)))

    def blocked(self, committee_id, now: Optional[float] = None) -> Optional[float]:
        if not self.enabled():
            return None
        now = time.monotonic() if now is None else now
        with self._lock:
            q = self._events.get(committee_id)
            if not q:
                return None
            self._prune(q, now)
            if not q:
                del self._events[committee_id]
                return None
            if sum(n for _ts, n in q) <= self.budget:
                return None
            # retry once the oldest charge ages out of the window
            return max(0.1, self.window_s - (now - q[0][0]))
