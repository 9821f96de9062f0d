"""Bounded, secret-hygienic precompute pools.

Most of a `distribute()` does not depend on the epoch's inputs: the
Paillier randomizer powers r^n mod n^2 and the sigma-protocol beta^n
columns, the mod-N~ first-message commitments, and fresh key material
with its proofs. This module is the offline half of the MPC
offline/online split: pools of single-use entries produced ahead of the
refresh round (by `producer.prefill`, through the same batch engines)
and consumed by a prefilled committee's `distribute()` at each phase
boundary, with per-row inline fallback when a pool runs dry. The
consumed values are the ones the inline path would have sampled and
computed, so transcripts do not depend on the pools
(tests/test_torch_precompute.py). An own copy of
fsdkr_tpu/precompute/pools.py: the event counts (`fsdkr_pool_events`,
read back by `precompute_stats`), the pooled bytes, the dry fallbacks
by cause and the occupancy gauges are in the telemetry registry.

## Pool kinds

- ("enc", n): Paillier encryption randomizers for receiver modulus n —
  entries (r, r^n mod n^2) with r drawn exactly like
  `paillier.sample_randomness`.
- ("pdl", (h1, h2, N~, n)) and ("alice", (h1, h2, N~, n)): sigma
  first-messages for one receiver environment — entries
  (alpha, beta, rho, gamma, beta^n mod n^2, h2^rho mod N~,
  h1^alpha*h2^gamma mod N~). The witness-dependent factor h1^x stays
  online; the Fiat-Shamir challenge binds the commitments only AFTER
  the (online) statement is fixed, so nothing challenge-derived is ever
  poolable.
- ("keys", (paillier_bits, m_security, correct_key_rounds, hash_alg)):
  complete key-material bundles (ek, dk, NiCorrectKeyProof,
  RingPedersenStatement, RingPedersenProof) — both proofs are functions
  of the fresh key alone, so the whole block is offline.

## Secret hygiene

Every entry is secret material. Entries live ONLY in this module's
in-process store — never the public precompute cache (`utils/lru.py`).
Entries are STRICTLY single-use: `PoolEntry.take()` returns the values
once, drops the references, and raises `PrecomputeReuseError` forever
after — a reused sigma nonce answers two challenges and reveals the
witness. `clear_pools()` wipes every unconsumed entry.

Pool KEYS are broadcast-public values (receiver moduli, ring-Pedersen
bases, config parameters); only entry VALUES are secret.

A pool holds at most POOL_DEPTH entries under a POOL_BUDGET_BYTES total cap
(the JAX package's defaults).

## Injected dry storms

Under a serving fault plan (`serving.faults.configure`) the `pool_dry`
site forces a take dry on a full pool: the entry stays pooled, only that
take computes inline, and the dry fallback is counted with
cause=injected (`fsdkr_pool_dry`), apart from the real ones.
"""

from __future__ import annotations

import sys
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ..errors import PrecomputeReuseError

__all__ = [
    "PoolEntry",
    "PrecomputeStore",
    "get_store",
    "take",
    "put",
    "clear_pools",
    "precompute_stats",
    "stats_reset",
    "secret_values",
]

POOL_DEPTH = 64  # entries per (kind, key): four n=16 epochs ahead
POOL_BUDGET_BYTES = 64 << 20
_EVENTS = ("produced", "consumed", "dry_fallbacks", "wiped")
# the serving fault plan, looked up and never imported: a process that
# never configured chaos pays one dict lookup a take
_FAULTS_MODULE = __name__.rsplit(".", 2)[0] + ".serving.faults"


def _events():
    """Pool events by event and kind (produced, consumed, dry_fallbacks,
    wiped): counts only, never values."""
    from ..telemetry import registry

    return registry.counter(
        "fsdkr_pool_events",
        "precompute pool events (produced/consumed/dry_fallbacks/wiped)",
        labelnames=("event", "kind"),
    )


def _bytes_gauge():
    from ..telemetry import registry

    return registry.gauge(
        "fsdkr_pool_bytes",
        "total bytes currently pooled (budget: FSDKR_POOL_BUDGET_MB)",
    )


def _dry_events():
    """Dry fallbacks by kind and cause (real | injected): an injected
    pool-dry storm must be distinguishable from a producer that cannot
    keep up."""
    from ..telemetry import registry

    return registry.counter(
        "fsdkr_pool_dry",
        "pool dry fallbacks by kind and cause (real | injected)",
        labelnames=("kind", "cause"),
    )


def _injected_dry() -> bool:
    m = sys.modules.get(_FAULTS_MODULE)
    if m is None:
        return False
    plan = m.active()
    return plan is not None and plan.fire_seq("pool_dry")


def _nbytes(v) -> int:
    """Byte estimate of an entry value for the pool budget: ints by bit
    length, containers and proof/statement objects by their int fields."""
    if isinstance(v, int):
        return v.bit_length() // 8 + 1
    if isinstance(v, (list, tuple)):
        return sum(_nbytes(x) for x in v)
    d = getattr(v, "__dict__", None)
    if d:
        return sum(_nbytes(x) for x in d.values())
    slots = getattr(type(v), "__slots__", None)
    if slots:
        return sum(_nbytes(getattr(v, s, 0)) for s in slots)
    return 64


class PoolEntry:
    """One single-use pooled value set. `take()` returns the values
    exactly once and drops the internal references; any further take
    raises PrecomputeReuseError."""

    __slots__ = ("_values", "nbytes")

    def __init__(self, values: tuple):
        self._values = tuple(values)
        self.nbytes = _nbytes(self._values)

    def take(self) -> tuple:
        if self._values is None:
            raise PrecomputeReuseError()
        v = self._values
        self._values = None  # int-level wipe: drop the only pool refs
        return v

    def wipe(self) -> None:
        self._values = None


class PrecomputeStore:
    """Per-session store of pools keyed by (kind, key). Bounded by
    per-key depth and a total byte budget; FIFO within a pool so
    consumption order matches production order (the seeded-parity
    contract). Thread-safe: the background producer puts while
    distribute() takes. Event counts by kind; entry VALUES never leave
    this module."""

    def __init__(self):
        self._pools: Dict[Tuple, deque] = OrderedDict()
        self._lock = threading.RLock()
        self._bytes = 0

    def _event(self, event: str, kind: str, k: int = 1) -> None:
        _events().inc(k, event=event, kind=kind)

    def _set_bytes(self, nbytes: int) -> None:
        self._bytes = nbytes
        _bytes_gauge().set(nbytes)

    # -- consumption ----------------------------------------------------
    def take(self, kind: str, key) -> Optional[tuple]:
        """Pop and consume the oldest entry of pool (kind, key); None
        (counted as a dry fallback) when the pool is dry — the caller
        then computes inline, with the same values. An injected pool-dry
        fault starves this take alone: the entry stays pooled."""
        if _injected_dry():
            with self._lock:
                self._event("dry_fallbacks", kind)
            _dry_events().inc(kind=kind, cause="injected")
            return None
        with self._lock:
            pool = self._pools.get((kind, key))
            if not pool:
                self._event("dry_fallbacks", kind)
                _dry_events().inc(kind=kind, cause="real")
                return None
            ent = pool.popleft()
            if not pool:
                # drop the empty shell: refresh rotates pool keys every
                # epoch, so drained pools are never refilled under the
                # same key
                del self._pools[(kind, key)]
            self._set_bytes(self._bytes - ent.nbytes)
            self._event("consumed", kind)
        return ent.take()

    # -- production -----------------------------------------------------
    def put(self, kind: str, key, values: tuple) -> bool:
        """Append one entry; False (entry wiped, not stored) when the
        per-key depth or the total byte budget is exhausted."""
        ent = PoolEntry(values)
        with self._lock:
            pool = self._pools.setdefault((kind, key), deque())
            if len(pool) >= POOL_DEPTH or self._bytes + ent.nbytes > POOL_BUDGET_BYTES:
                if not pool:
                    del self._pools[(kind, key)]
                ent.wipe()
                self._event("wiped", kind)
                return False
            pool.append(ent)
            self._set_bytes(self._bytes + ent.nbytes)
            self._event("produced", kind)
            return True

    def depths_by_kind(self) -> Dict[str, int]:
        """Entries currently pooled, summed per kind."""
        out: Dict[str, int] = {}
        with self._lock:
            for (kind, _key), pool in self._pools.items():
                out[kind] = out.get(kind, 0) + len(pool)
        return out

    def pool_count(self) -> int:
        with self._lock:
            return len(self._pools)

    def depth(self, kind: str, key) -> int:
        with self._lock:
            pool = self._pools.get((kind, key))
            return len(pool) if pool else 0

    def room(self, kind: str, key, want: int) -> int:
        """How many entries pool (kind, key) can still absorb toward a
        target of `want` (producer scheduling)."""
        with self._lock:
            return max(0, min(want, POOL_DEPTH) - self.depth(kind, key))

    # -- teardown / accounting ------------------------------------------
    def drop(self, kind: str, key) -> None:
        """Wipe and remove one whole pool (target retirement: refresh
        rotates receiver moduli every epoch, so pools keyed by retired
        moduli hold never-again-consumable secrets)."""
        with self._lock:
            pool = self._pools.pop((kind, key), None)
            if not pool:
                return
            for ent in pool:
                self._set_bytes(self._bytes - ent.nbytes)
                ent.wipe()
            self._event("wiped", kind, len(pool))
            pool.clear()

    def clear(self) -> None:
        """Wipe every unconsumed entry (session teardown, tests, A/B)."""
        with self._lock:
            for (kind, _key), pool in self._pools.items():
                for ent in pool:
                    ent.wipe()
                self._event("wiped", kind, len(pool))
                pool.clear()
            self._pools.clear()
            self._set_bytes(0)

    def snapshot(self, by_kind: bool = False) -> Dict:
        """Event totals, bytes and entries pooled; with `by_kind`, also
        each event's counts by kind under "kinds"."""
        events = {(rec["labels"]["event"], rec["labels"]["kind"]): int(rec["value"])
                  for rec in _events().snapshot_values()}
        with self._lock:
            out: Dict = {
                e: sum(v for (ev, _k), v in events.items() if ev == e)
                for e in _EVENTS
            }
            out.update(
                bytes_pooled=self._bytes,
                entries=sum(len(p) for p in self._pools.values()),
                pools=len(self._pools),
            )
            if by_kind:
                kinds: Dict[str, Dict[str, int]] = {}
                for (ev, kind), v in events.items():
                    kinds.setdefault(kind, {})[ev] = v
                out["kinds"] = kinds
            return out

    def stats_reset(self) -> None:
        _events().reset()
        with self._lock:
            _bytes_gauge().set(self._bytes)

    def secret_values(self) -> List[int]:
        """Every int currently pooled, recursing into proof/statement/key
        objects as _nbytes does — the key-material bundles hold their
        secrets (dk.p, dk.q, proof fields) inside objects (the tests
        assert none of these ever appears in the public cache)."""
        out: List[int] = []

        def walk(v):
            if isinstance(v, bool) or v is None:
                return
            if isinstance(v, int):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    walk(x)
            else:
                d = getattr(v, "__dict__", None)
                if d:
                    for x in d.values():
                        walk(x)
                else:
                    for s in getattr(type(v), "__slots__", ()):
                        walk(getattr(v, s, None))

        with self._lock:
            for pool in self._pools.values():
                for ent in pool:
                    if ent._values is not None:
                        walk(ent._values)
        return out


_STORE = PrecomputeStore()


def _register_gauges() -> None:
    from ..telemetry import registry

    registry.gauge(
        "fsdkr_pool_depth",
        "entries currently pooled, per kind (pool-occupancy gauge)",
        labelnames=("kind",),
    ).set_labeled_function(
        lambda: {(k,): v for k, v in _STORE.depths_by_kind().items()}
    )
    registry.gauge(
        "fsdkr_pool_count",
        "distinct (kind, key) pools currently held",
    ).set_function(_STORE.pool_count)


_register_gauges()


def get_store() -> PrecomputeStore:
    return _STORE


def take(kind: str, key) -> Optional[tuple]:
    return _STORE.take(kind, key)


def put(kind: str, key, values: tuple) -> bool:
    return _STORE.put(kind, key, values)


def clear_pools() -> None:
    _STORE.clear()


def precompute_stats(by_kind: bool = False) -> Dict:
    return _STORE.snapshot(by_kind)


def stats_reset() -> None:
    _STORE.stats_reset()


def secret_values() -> List[int]:
    return _STORE.secret_values()
