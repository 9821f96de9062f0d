"""Bytes-budgeted LRU for persistent precompute over public moduli.

One process-wide cache holds the precompute that is a pure function of
PUBLIC launch parameters and repeats across `collect()` /
`distribute_batch()` calls of a stable committee: the CIOS engine's
Montgomery contexts (keyed by the modulus vector, `backend.powm`) and
the RNS route's per-modulus constants (`ops.rns._row_consts`). Entries
are only ever read under full-key equality, so two committees never
share an entry.

SECURITY invariant: values stored here derive ONLY from public moduli
and static geometry. Bases, exponents, shares, nonces and results (all
covered by the wipe discipline, `ops.limbs.wipe_array`) are never
inserted.

Budget: FSDKRC_CACHE_BUDGET_MB megabytes (default 512; 0 disables the
cache). Overflow evicts the least recently used entries one at a time,
never the whole cache.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

__all__ = ["BudgetLRU", "global_cache", "cache_stats", "clear_caches"]


class BudgetLRU:
    """Thread-safe LRU keyed by hashable tuples, evicting by byte budget.

    Each entry carries the caller's byte estimate; `put` evicts the
    oldest entries until the new one fits. An entry larger than the
    whole budget is not cached (callers then build it per call).
    """

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._d: OrderedDict = OrderedDict()
        self._bytes: Dict[Any, int] = {}
        self._total = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key) -> Optional[Any]:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def peek(self, key) -> Optional[Any]:
        """Presence probe that counts no hit or miss and leaves the
        recency order as it is."""
        with self._lock:
            return self._d.get(key)

    def put(self, key, value, nbytes: int) -> None:
        nbytes = max(1, int(nbytes))
        with self._lock:
            if nbytes > self.budget:
                return  # larger than the whole budget: never cached
            if key in self._d:
                self._total -= self._bytes.pop(key)
                del self._d[key]
            while self._total + nbytes > self.budget and self._d:
                old_key, _ = self._d.popitem(last=False)  # oldest first
                self._total -= self._bytes.pop(old_key)
                self.evictions += 1
            self._d[key] = value
            self._bytes[key] = nbytes
            self._total += nbytes

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._bytes.clear()
            self._total = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._d),
                "bytes": self._total,
                "budget": self.budget,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }


_GLOBAL: Optional[BudgetLRU] = None
_GLOBAL_LOCK = threading.Lock()


def _budget_bytes() -> int:
    try:
        mb = float(os.environ.get("FSDKRC_CACHE_BUDGET_MB", "512"))
    except ValueError:
        mb = 512.0
    return int(mb * (1 << 20))


def global_cache() -> BudgetLRU:
    """The process-wide precompute cache (budget read once at first use)."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = BudgetLRU(_budget_bytes())
    return _GLOBAL


def cache_stats() -> Dict[str, int]:
    """Counters of the global precompute cache (zeros before first use)."""
    if _GLOBAL is None:
        return {
            "entries": 0, "bytes": 0, "budget": _budget_bytes(),
            "hits": 0, "misses": 0, "evictions": 0,
        }
    return _GLOBAL.stats()


def clear_caches() -> None:
    """Drop every cached entry (cold-cache runs; tests)."""
    if _GLOBAL is not None:
        _GLOBAL.clear()
