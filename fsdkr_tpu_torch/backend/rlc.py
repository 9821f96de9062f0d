"""Cross-proof randomized batch verification for the modexp families (the
JAX package's backend.rlc, cut to what the port's verifier runs).

Bellare-Garay-Rabin small-exponent random linear combination (RLC):
verification rows that share a modulus (all ring-Pedersen rows of one
proof mod N, all correct-key rounds of one proof mod N, the n PDL rows
addressed to one receiver mod N~ and mod n^2) fold into ONE combined
equation per group,

    prod_i (lhs_i / rhs_i)^{rho_i} == 1  (mod M),

with secret fresh rho_i in [1, 2^128) drawn from the OS CSPRNG per
check. A group holding at least one failing row passes with probability
at most 2^-128 over the verifier's own coins (SECURITY.md gives the
bound's fine print in groups of unknown order). Division never happens:
each family's fold moves terms so that both sides are products of
non-negative powers, and the check is an equality of two computed group
elements.

Where the per-row check costs one full-width (2048/4096-bit) chain a
row, the folded check costs O(1) full-width chains a GROUP (the bases
shared across rows, h1, h2, T and the group's shared exponent n or N,
merge into one full-width term) plus one short aggregated chain over the
per-row bases, whose exponents are only 128-384 bits wide.

Blame: a failing combined check bisects (`bisect_rows`): subsets are
re-checked with fresh rho, and leaves take the exact per-row equation,
so a row is marked INVALID only through its exact check. All-valid
subsets pass with probability 1 (products of true equations), so false
blame cannot happen; a passing subset is taken as all-valid with the
group's soundness error.

Fused sessions: a failing group whose rows come from more than one
session of a fused `collect_sessions` call bisects session-first
(`bisect_sessions`), so an honest session beside a tampered one is
cleared by one combined sub-check. Memory plan: a group whose rows span
several tiles folds as a running partial product (`StreamFold`).

`FSDKRC_RLC` gates the whole mechanism (default on); 0, off, false or
no turn every caller back to the per-row column and joint layouts.
"""

from __future__ import annotations

import os
import secrets
import threading
from typing import Callable, Dict, List, Sequence

__all__ = [
    "RLC_BITS",
    "rlc_enabled",
    "sample_rhos",
    "bisect_rows",
    "bisect_sessions",
    "StreamFold",
    "stats",
    "stats_reset",
    "count",
]

RLC_BITS = 128


def rlc_enabled() -> bool:
    """FSDKRC_RLC (default on; 0, off, false or no turn it off), read at
    call time: the verifier's RLC arms for PDL, ring-Pedersen and
    correct-key (the JAX package's FSDKR_RLC). Off, those families take
    the per-row column and joint layouts. Verdicts are the same either
    way."""
    return os.environ.get("FSDKRC_RLC", "1").lower() not in ("0", "off", "false", "no")


def sample_rhos(count: int) -> List[int]:
    """count secret coefficients rho_i in [1, 2^128), fresh from the OS
    CSPRNG. Never cached, never persisted, never part of any cache key:
    rho only ever flows into exponent staging buffers, which the engine
    wipes after upload."""
    top = (1 << RLC_BITS) - 1
    return [1 + secrets.randbelow(top) for _ in range(count)]


# Fold statistics: how many groups folded, how many per-row equations they
# absorbed, how many full-width ladders the folded plan still launches
# (one a group), and how many groups fell back to bisection. The JAX
# package keeps them in its telemetry registry, which the port does not
# have: a module-level dict over the same event names. The ladder-cache
# events (the JAX package's host comb-table cache, which the port does not
# need) stay 0.
_EVENTS = (
    "rlc_groups", "rows_folded", "fullwidth_ladders", "bisect_fallbacks",
    "stream_tiles", "session_bisects", "ladder_cache_hits",
    "ladder_cache_misses", "xsession_rows_deduped",
)
_COUNTS: Dict[str, int] = dict.fromkeys(_EVENTS, 0)
# the serving layer's worker and launcher threads verify side by side
_COUNTS_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    with _COUNTS_LOCK:
        _COUNTS[name] += n


def stats() -> Dict[str, int]:
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def stats_reset() -> None:
    with _COUNTS_LOCK:
        for name in _EVENTS:
            _COUNTS[name] = 0


def bisect_rows(
    indices: Sequence[int],
    combined_check: Callable[[List[int]], bool],
    row_check: Callable[[int], bool],
    leaf: int = 2,
) -> Dict[int, bool]:
    """Per-row verdicts for a group whose combined check failed.

    Halves the row set: a subset passing `combined_check` (fresh rho each
    call) is marked all-valid, a failing one splits further until `leaf`
    rows remain, which the exact `row_check` decides. Rows are marked
    INVALID only through the exact check. A group with b bad rows costs
    O(b log n) combined sub-checks plus O(b * leaf) exact row checks."""
    out: Dict[int, bool] = {}
    stack: List[List[int]] = [list(indices)]
    while stack:
        rows = stack.pop()
        if len(rows) <= leaf:
            for i in rows:
                out[i] = bool(row_check(i))
            continue
        mid = (len(rows) + 1) // 2
        for half in (rows[:mid], rows[mid:]):
            if combined_check(half):
                for i in half:
                    out[i] = True
            else:
                stack.append(half)
    return out


def bisect_sessions(
    indices: Sequence[int],
    session_of: Callable[[int], int],
    combined_check: Callable[[List[int]], bool],
    row_check: Callable[[int], bool],
    leaf: int = 2,
) -> Dict[int, bool]:
    """`bisect_rows` with a session-first split, for a failing group whose
    rows were merged across fused sessions: the rows are partitioned by
    owning session (absorption order kept within each), each session's
    subset is combined-checked once, and only the failing sessions bisect
    further. An honest session fused with a tampered one is cleared by one
    combined sub-check, never row-checked, and every row is decided by the
    same `bisect_rows` / `row_check` an unfused collect uses. With rows of
    one session only, this is `bisect_rows`."""
    by_session: Dict[int, List[int]] = {}
    for i in indices:
        by_session.setdefault(session_of(i), []).append(i)
    if len(by_session) <= 1:
        return bisect_rows(indices, combined_check, row_check, leaf)
    out: Dict[int, bool] = {}
    for rows in by_session.values():
        count("session_bisects")
        if combined_check(rows):
            out.update(dict.fromkeys(rows, True))
        else:
            out.update(bisect_rows(rows, combined_check, row_check, leaf))
    return out


class StreamFold:
    """The running state of one RLC group folded across the tiles of the
    memory plan (backend.memplan). The combined check factorises over any
    partition of the group's rows, so a tile contributes its partial
    products over the per-row bases (its short aggregated chains, `prods`:
    one slot for the PDL mod-N~ fold, two for mod n^2) and the integer
    sums of its merged shared-base exponents (`exp_sums`); the full-width
    ladders of the shared bases run once a group at finish, as in the
    monolithic fold. `rows` are the absorbed global row indices, in
    absorption order, for the bisection. No rho is kept: each tile draws
    its own, fresh, and folds it in."""

    __slots__ = ("modulus", "prods", "exp_sums", "rows")

    def __init__(self, modulus: int, n_prods: int = 1, n_exps: int = 0):
        self.modulus = modulus
        self.prods = [1] * n_prods
        self.exp_sums = [0] * n_exps
        self.rows: List[int] = []

    def absorb(self, prod_vals, exp_vals=(), rows=()) -> None:
        m = self.modulus
        for i, v in enumerate(prod_vals):
            self.prods[i] = self.prods[i] * v % m
        for i, e in enumerate(exp_vals):
            self.exp_sums[i] += e
        self.rows.extend(rows)
