"""Deterministic, seed-driven fault injection for the serving stack (an
own copy of fsdkr_tpu/serving/faults.py).

This module is the ONE place chaos comes from: a parsed fault PLAN
consulted by thin hooks at named sites, so every injected fault is
deliberate, reproducible, and stamped into telemetry. A plan is
installed only by `configure(spec)` (the JAX package also reads
FSDKR_FAULTS; the port reads no environment) and removed by `reset()`.

## Spec string

``"seed=42,msg_tamper=0.05,worker_crash=0.02,..."`` — comma-separated
``key=value`` pairs. Keys are either a SITE name with a fire
probability in [0, 1], a per-site total cap ``<site>_max=N`` (useful in
tests to fire exactly once), or one of the scalar tuning knobs
(``seed``, ``delay_s``, ``squeeze_factor``). Unknown keys raise at parse
time — a typo must not silently disable a chaos run.

Sites (each hook passes a stable key; the decision is a pure function
of ``(seed, site, key)``, so a run with a fixed seed injects the same
faults at the same sessions every time, regardless of thread timing,
for every site whose key is schedule-independent):

- ``worker_crash``   — a serving worker thread dies at session start
  (keyed by session id + attempt; the service respawns the worker and
  retries or aborts only that session).
- ``finalize_exc``   — the fused finalize launch raises before running
  (keyed by batch + attempt; strictly BEFORE `finalize_streams`, so a
  retry replays a pure function over staged public messages).
- ``pool_dry``       — a precompute pool take is forced dry (keyed by a
  per-process call counter; the consumer falls back inline, with the
  same values, and the dry is labeled cause=injected).
- ``msg_delay``      — a broadcast message arrives ``delay_s`` late
  (keyed by session id + sender).
- ``msg_drop``       — a broadcast message never arrives (same key);
  the session can only end via the deadline reaper, which names the
  missing senders.
- ``msg_dup``        — a broadcast message is delivered twice.
- ``msg_tamper``     — the delivered message is a tampered copy (the
  ``pdl_s1`` tamper); the honest copy follows as a duplicate, and
  first-arrival-wins means the session MUST abort with blame.
- ``mem_squeeze``    — the memory plan's budget is squeezed by
  ``squeeze_factor`` for one planning decision (keyed by a call
  counter; verification tiles harder, verdicts do not change).
- ``journal_torn_write`` — truncate the active journal segment
  mid-record (keyed by a call counter): the torn-tail replay path is
  exercised end to end.

- ``shard_kill``     — SIGKILL a live RefreshService shard mid-window
  (`ShardSupervisor.chaos_kill`, keyed by the caller's tick; acted out
  by `kill_shard`). The supervisor's failover re-homes its committees.
- ``conn_drop``      — the ingress closes a connection as a request
  frame arrives (keyed by connection + frame sequence).
- ``frame_truncate`` — the ingress writes a third of a response frame,
  then resets the connection (same key).
- ``net_delay``      — a response is written ``delay_s`` late.
- ``net_dup``        — a response is written twice (the client drops
  the copy by its rid).

## Zero cost when disabled

Without `configure()`, `active()` returns None and every hook is one
attribute read. Hooks outside the serving package
(precompute/pools.py, backend/memplan.py) look this module up in
``sys.modules`` and never import it.

## Telemetry

Every fired fault increments ``fsdkr_fault_injected{site}`` and lands
in the flight recorder (kind="fault"). Fault keys are session ids,
sender indices or counters — never key material.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import threading
from typing import Dict, Optional, Tuple

from ..telemetry import flight, registry

__all__ = [
    "SITES",
    "InjectedFault",
    "InjectedWorkerCrash",
    "InjectedFinalizeError",
    "FaultPlan",
    "active",
    "configure",
    "reset",
    "tamper_message",
]

SITES = (
    "worker_crash",
    "finalize_exc",
    "pool_dry",
    "msg_delay",
    "msg_drop",
    "msg_dup",
    "msg_tamper",
    "mem_squeeze",
    "shard_kill",
    "journal_torn_write",
    "conn_drop",
    "frame_truncate",
    "net_delay",
    "net_dup",
)

_SCALARS = ("seed", "delay_s", "squeeze_factor")


class InjectedFault(RuntimeError):
    """Base of every injected failure. Deliberately NOT an FsDkrError:
    injected faults are infrastructure failures (transient, retryable),
    never protocol verdicts — the service must never translate one into
    identifiable-abort blame."""


class InjectedWorkerCrash(InjectedFault):
    """Raised inside a serving worker to simulate the thread dying."""


class InjectedFinalizeError(InjectedFault):
    """Raised at the head of a fused finalize launch (transient)."""


def _counter():
    return registry.counter(
        "fsdkr_fault_injected",
        "faults injected by the FSDKR_FAULTS plan, by site",
        labelnames=("site",),
    )


class FaultPlan:
    """One parsed fault plan. Decisions are pure functions of
    (seed, site, key) via SHA-256, so they are reproducible across
    processes and independent of Python hash randomization."""

    def __init__(
        self,
        seed: int = 0,
        rates: Optional[Dict[str, float]] = None,
        caps: Optional[Dict[str, int]] = None,
        delay_s: float = 0.25,
        squeeze_factor: float = 0.25,
    ):
        self.seed = int(seed)
        self.rates = dict(rates or {})
        self.caps = dict(caps or {})
        self.delay_s = float(delay_s)
        self.squeeze_factor = min(1.0, max(0.01, float(squeeze_factor)))
        self._lock = threading.Lock()
        self._fired: Dict[str, int] = {}
        self._seq: Dict[str, int] = {}

    # -- construction ---------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        seed, delay_s, squeeze = 0, 0.25, 0.25
        rates: Dict[str, float] = {}
        caps: Dict[str, int] = {}
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"fault plan: bad entry {part!r}")
            k, v = (x.strip() for x in part.split("=", 1))
            if k == "seed":
                seed = int(v)
            elif k == "delay_s":
                delay_s = float(v)
            elif k == "squeeze_factor":
                squeeze = float(v)
            elif k in SITES:
                rates[k] = min(1.0, max(0.0, float(v)))
            elif k.endswith("_max") and k[:-4] in SITES:
                caps[k[:-4]] = int(v)
            else:
                raise ValueError(
                    f"fault plan: unknown key {k!r} (sites: {SITES}, "
                    f"scalars: {_SCALARS}, caps: <site>_max)"
                )
        return cls(seed, rates, caps, delay_s, squeeze)

    def spec(self) -> str:
        """Canonical spec string (stamped into chaos reports)."""
        parts = [f"seed={self.seed}"]
        parts += [f"{s}={self.rates[s]}" for s in SITES if s in self.rates]
        parts += [f"{s}_max={self.caps[s]}" for s in SITES if s in self.caps]
        parts += [f"delay_s={self.delay_s}",
                  f"squeeze_factor={self.squeeze_factor}"]
        return ",".join(parts)

    # -- decisions ------------------------------------------------------
    def _roll(self, site: str, key: Tuple) -> bool:
        rate = self.rates.get(site, 0.0)
        if rate <= 0.0:
            return False
        h = hashlib.sha256(
            f"{self.seed}|{site}|{key!r}".encode()
        ).digest()
        return int.from_bytes(h[:8], "big") < rate * (1 << 64)

    def fire(self, site: str, key: Tuple = ()) -> bool:
        """Decide-and-record: True iff the plan injects `site` for this
        key (under the site's rate and its optional total cap). A True
        return is already stamped into telemetry + the flight
        recorder — the caller's only job is to act the fault out."""
        if not self._roll(site, key):
            return False
        cap = self.caps.get(site)
        with self._lock:
            n = self._fired.get(site, 0)
            if cap is not None and n >= cap:
                return False
            self._fired[site] = n + 1
        _counter().inc(site=site)
        flight.record("fault", site, key=repr(key)[:64])
        return True

    def fire_seq(self, site: str) -> bool:
        """fire() keyed by a per-site process-wide call counter — for
        sites with no natural stable key (pool takes, memplan budget
        reads). Still seed-deterministic given the call order; the
        injected COUNT converges to rate x calls regardless."""
        with self._lock:
            k = self._seq[site] = self._seq.get(site, 0) + 1
        return self.fire(site, (k,))

    def squeeze_budget(self, budget: int) -> int:
        """mem_squeeze hook: one planning decision's bytes budget,
        possibly squeezed. The plan never raises a budget."""
        if self.fire_seq("mem_squeeze"):
            return max(1, int(budget * self.squeeze_factor))
        return budget

    def injected(self) -> Dict[str, int]:
        """Total fires per site so far (chaos-report accounting)."""
        with self._lock:
            return dict(self._fired)


def tamper_message(msg):
    """Tampered deep copy of a RefreshMessage — the ``pdl_s1`` tamper
    (s1 of the first PDL proof bumped), a pure wire-level mutation of broadcast-public data. The session
    verifying it must abort with PDLwSlackProofError blame on this
    sender, streaming and barrier alike."""
    bad = copy.deepcopy(msg)
    bad.pdl_proof_vec[0] = dataclasses.replace(
        bad.pdl_proof_vec[0], s1=bad.pdl_proof_vec[0].s1 + 1
    )
    return bad


# ---------------------------------------------------------------------------
# module-level activation: configure() / reset() only

_OVERRIDE: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    """The live fault plan, or None (no configure() since the last
    reset())."""
    return _OVERRIDE


def configure(spec) -> FaultPlan:
    """Install a plan (a spec string or a FaultPlan) until reset();
    returns it so callers can read `injected()` afterwards."""
    global _OVERRIDE
    _OVERRIDE = FaultPlan.parse(spec) if isinstance(spec, str) else spec
    return _OVERRIDE


def reset() -> None:
    global _OVERRIDE
    _OVERRIDE = None
