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

`FSDKRC_RLC` gates the whole mechanism (default on); 0, off, false or
no turn every caller back to the per-row column and joint layouts.

Left out with their callers, which the port does not have yet: the
streamed fold (`StreamFold`), the session-first bisection and the
cross-session dedup knob.
"""

from __future__ import annotations

import os
import secrets
from typing import Callable, Dict, List, Sequence

__all__ = [
    "RLC_BITS",
    "rlc_enabled",
    "sample_rhos",
    "bisect_rows",
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
# have: a module-level dict over the same event names. Events that no
# ported path raises stay 0.
_EVENTS = (
    "rlc_groups", "rows_folded", "fullwidth_ladders", "bisect_fallbacks",
    "stream_tiles", "session_bisects", "ladder_cache_hits",
    "ladder_cache_misses", "xsession_rows_deduped",
)
_COUNTS: Dict[str, int] = dict.fromkeys(_EVENTS, 0)


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] += n


def stats() -> Dict[str, int]:
    return dict(_COUNTS)


def stats_reset() -> None:
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
