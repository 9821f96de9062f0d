"""Secret-CRT modexp engine for prover-owned moduli.

Everywhere the prover owns the factorization of its modulus — the
ring-Pedersen setup S = T^lambda and its M-round commitment column
(`proofs/ring_pedersen.py`), the correct-key N-th roots
(`proofs/correct_key.py`), and the Paillier decrypt legs
(`core/paillier.py`) — a full-width modexp mod N = p*q decomposes into
two half-width legs with exponents reduced modulo the leg group orders:

    x^e mod N  =  Garner( x^{e mod (p-1)} mod p,  x^{e mod (q-1)} mod q )

(lambda-reduced mod p^2/q^2 on the N^2 shapes). Each leg costs ~1/8 of
the full ladder (half the squarings at a quarter the per-multiply
price). The legs run on GMP's constant-time `mpz_powm_sec`
(native/gmp.py, `secret=True`): their exponents come from the
factorization. The fixed-base column's legs run on the native core's
one-shot comb (fsdkr_tpu_torch/native). An own copy of
fsdkr_tpu/backend/crt.py.

## Fault check (Bellcore), mandatory

A single faulted CRT leg is catastrophic: if S' differs from the true
S = x^e mod N in exactly one leg, gcd(S' - S mod N, N) recovers a prime
factor (Boneh-DeMillo-Lipton). Every leg here is therefore computed
modulo p*r (q*r) for a FRESH 64-bit prime r drawn from the OS CSPRNG per
engine call, and the leg is re-verified modulo r against an
independently computed 64-bit reference pow(x mod r, e mod (r-1), r) —
valid because (r-1) divides the leg's exponent-reduction modulus
lcm(leg_order, r-1), and checked against the ORIGINAL unreduced
exponent, so a fault in the reduction staging is caught too. The
recombined value is additionally re-checked against both leg residues.
Any mismatch raises CrtFaultError BEFORE any output is produced or any
partial value escapes. A random fault survives each check with
probability ~2^-64.

## Secret store

CRT contexts (p, q, leg orders, the Garner coefficient q^{-1} mod p —
all factorization-equivalent) live in a per-session in-process store in
THIS module, never in the public precompute cache (`utils/lru.py`),
whose entries are public values only. The store is bounded, clears on
demand (`clear_store()`), and wipes by reference-dropping plus container
clearing — the Python-int leg of the zeroize discipline.
`tests/test_torch_crt.py` pins that no factorization-derived integer
reaches the public cache.

## Callers

Ring-Pedersen's S = T^lambda (one row a statement) and Paillier decrypt's
fault-checked legs always take the legs: on the card a single row is a
launch of one, and the host's full-width pow is slower than two half
legs. The correct-key rows and ring-Pedersen's M-row commitment column
take the legs only on the host engine (`backend.powm.crt_powm`,
`RingPedersenProof.prove_batch`): on the cuda backend their full-width columns run on the
card's kernels, which beat the host's legs there (PERF.md section 5) and
need no fault check, since no CRT is used. The values are the same
either way (the decomposition is an arithmetic identity).
"""

from __future__ import annotations

import math
import secrets
import threading
from typing import Dict, List, Optional, Sequence

from ..errors import CrtFaultError

__all__ = [
    "CrtContext",
    "get_context",
    "clear_store",
    "store_stats",
    "crt_modexp_batch",
    "crt_powm_shared",
    "fault_checked_powm",
    "crt_stats",
    "stats_reset",
]


class CrtContext:
    """Factorization-derived constants for one prover-owned modulus.

    p_leg/q_leg are the leg moduli (p and q, or p^2 and q^2 for the N^2
    shapes); d_p/d_q the exponent-reduction moduli (the leg group
    orders p-1 / q-1, or p(p-1) / q(q-1)); qinv the Garner coefficient
    q_leg^{-1} mod p_leg. Every field is secret: holding any of them is
    holding the factorization.
    """

    __slots__ = ("modulus", "p_leg", "q_leg", "d_p", "d_q", "qinv")

    def __init__(self, modulus: int, p: int, q: int):
        if p <= 2 or q <= 2 or p == q:
            raise ValueError("CRT context needs two distinct odd primes")
        if modulus == p * q:
            self.p_leg, self.q_leg = p, q
            self.d_p, self.d_q = p - 1, q - 1
        elif modulus == (p * q) ** 2:
            # lambda(p^2) = p(p-1) for odd prime p
            self.p_leg, self.q_leg = p * p, q * q
            self.d_p, self.d_q = p * (p - 1), q * (q - 1)
        else:
            raise ValueError("modulus is neither p*q nor (p*q)^2")
        self.modulus = modulus
        self.qinv = pow(self.q_leg, -1, self.p_leg)

    def wipe(self) -> None:
        """Drop the factorization-derived references (Python ints cannot
        be overwritten in place; this is the int-level wipe)."""
        self.modulus = self.p_leg = self.q_leg = 0
        self.d_p = self.d_q = self.qinv = 0


class _SecretStore:
    """Per-session store of CrtContexts, keyed by modulus. Deliberately
    NOT utils.lru: entries are factorization-equivalent secrets and must
    never ride the persistent public cache. Bounded (oldest wiped on
    overflow), thread-safe, wiped wholesale by clear_store()."""

    MAX_ENTRIES = 4096

    def __init__(self):
        self._d: Dict[int, CrtContext] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, modulus: int, p: int, q: int) -> CrtContext:
        with self._lock:
            ctx = self._d.get(modulus)
            if ctx is not None and ctx.p_leg and (
                modulus == p * q or modulus == (p * q) ** 2
            ):
                self.hits += 1
                return ctx
            self.misses += 1
            ctx = CrtContext(modulus, p, q)
            if len(self._d) >= self.MAX_ENTRIES:  # wipe the oldest entry
                old = self._d.pop(next(iter(self._d)))
                old.wipe()
            self._d[modulus] = ctx
            return ctx

    def clear(self) -> None:
        with self._lock:
            for ctx in self._d.values():
                ctx.wipe()
            self._d.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._d),
                "hits": self.hits,
                "misses": self.misses,
            }


_STORE = _SecretStore()


def get_context(modulus: int, p: int, q: int) -> CrtContext:
    """Context for a prover-owned modulus from the per-session secret
    store (built and inserted on miss). modulus must be p*q or (p*q)^2."""
    return _STORE.get_or_build(modulus, p, q)


def clear_store() -> None:
    """Wipe every stored CRT context (session teardown / tests)."""
    _STORE.clear()


def store_stats() -> Dict[str, int]:
    return _STORE.stats()


# ---------------------------------------------------------------------------
# Engine statistics: counts only, never values, on the process-global
# telemetry registry (one labeled counter for the engine events, function
# gauges for the secret store's occupancy). exp_bits_saved is priced from
# structural modulus widths (public-modulus bits minus leg bits per leg),
# never from exponent bit-lengths, which are secret-derived.

_EVENTS = ("rows", "legs", "fault_checks", "fallback_rows", "exp_bits_saved")


def _metric():
    from ..telemetry import registry

    return registry.counter(
        "fsdkr_crt_events",
        "secret-CRT prover engine statistics (backend.crt)",
        labelnames=("event",),
    )


def _count(**kw) -> None:
    m = _metric()
    for k, v in kw.items():
        m.inc(v, event=k)


def crt_stats() -> Dict[str, int]:
    """The engine's event counts since the last stats_reset()."""
    m = _metric()
    return {e: int(m.value(event=e)) for e in _EVENTS}


def stats_reset() -> None:
    _metric().reset()


def _register_store_gauges() -> None:
    from ..telemetry import registry

    registry.gauge(
        "fsdkr_crt_store_entries",
        "CRT secret-store occupancy (contexts held; values never exported)",
    ).set_function(lambda: _STORE.stats()["entries"])
    registry.gauge(
        "fsdkr_crt_store_hits",
        "CRT secret-store lifetime hits",
    ).set_function(lambda: _STORE.stats()["hits"])
    registry.gauge(
        "fsdkr_crt_store_misses",
        "CRT secret-store lifetime misses",
    ).set_function(lambda: _STORE.stats()["misses"])


_register_store_gauges()


# ---------------------------------------------------------------------------
# Fresh 64-bit fault-check prime

# Deterministic Miller-Rabin witness set for 64-bit candidates (exact
# below 3.3 * 10^24): the check prime itself is not secret-critical, but
# a composite r would silently weaken the fault check's 2^-64 bound.
_MR64_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _is_prime64(n: int) -> bool:
    if n < 2:
        return False
    for b in _MR64_BASES:
        if n % b == 0:
            return n == b
    d = n - 1
    s = (d & -d).bit_length() - 1
    d >>= s
    for b in _MR64_BASES:
        x = pow(b, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _fresh_check_prime(bases: Sequence[int]) -> int:
    """Fresh 64-bit prime from the OS CSPRNG, resampled until it divides
    no base in the batch (a base = 0 mod r would defeat the Fermat-form
    reference value; probability ~rows * 2^-63 per draw)."""
    while True:
        r = secrets.randbits(64) | (1 << 63) | 1
        if not _is_prime64(r):
            continue
        if any(b % r == 0 for b in bases):
            continue
        return r


# ---------------------------------------------------------------------------
# The half-width legs


def _leg_powm(bases: List[int], exps: List[int], mods: List[int]) -> List[int]:
    """One batch of CRT legs on mpz_powm_sec (GMP's constant-time ladder:
    the leg exponents are factorization-derived; every operand buffer
    wiped). Its roofline stamp prices the legs at the leg-modulus width:
    the exponents' bit-lengths must not reach an exported MAC count."""
    from ..native import gmp
    from ..telemetry.spans import get_tracer
    from ..utils.roofline import stamp_generic_host

    if bases and get_tracer().enabled:
        mod_bits = max(m.bit_length() for m in mods)
        stamp_generic_host(len(bases), mod_bits, mod_bits)
    return gmp.powm_batch(bases, exps, mods, secret=True)


def _check_leg(base: int, exp: int, r: int, leg_value: int) -> None:
    """Bellcore fault check for one leg computed mod p_leg*r: the leg's
    residue mod r must equal the independently computed 64-bit Fermat
    reference pow(base mod r, exp mod (r-1), r) — exp is the ORIGINAL
    unreduced exponent, so reduction-staging faults are caught too."""
    if leg_value % r != pow(base % r, exp % (r - 1), r):
        raise CrtFaultError()


def _recombine_checked(
    base: int, exp: int, r: int, sp: int, sq: int, ctx: CrtContext
) -> int:
    """The security-critical per-row sequence, in exactly one place for
    every CRT path: verify BOTH legs against the fresh prime BEFORE any
    recombination (a bad leg aborts without anything derived from it),
    Garner-recombine, then re-check the result against both leg residues
    and its range (a faulted Garner step is caught here)."""
    _check_leg(base, exp, r, sp)
    _check_leg(base, exp, r, sq)
    xp, xq = sp % ctx.p_leg, sq % ctx.q_leg
    v = xq + (xp - xq) * ctx.qinv % ctx.p_leg * ctx.q_leg
    if v % ctx.p_leg != xp or v % ctx.q_leg != xq or not (
        0 <= v < ctx.modulus
    ):
        raise CrtFaultError()
    return v


def crt_modexp_batch(
    bases: Sequence[int],
    exps: Sequence[int],
    contexts: Sequence[Optional[CrtContext]],
    fallback=None,
    moduli: Optional[Sequence[int]] = None,
) -> List[int]:
    """bases[i]^exps[i] mod contexts[i].modulus with CRT decomposition,
    fresh-prime fault checks, and Garner recombination. Rows whose
    context is None (modulus then read from `moduli`), whose base shares
    a factor with the modulus, or whose exponent is negative take
    `fallback(bases, exps, mods)` (pow when omitted) — exact, just not
    decomposed. Raises CrtFaultError (and returns nothing) if any leg or
    the recombination fails its check."""
    rows = len(bases)
    if rows == 0:
        return []
    if not (rows == len(exps) == len(contexts)):
        raise ValueError("batch length mismatch")

    def _mod(i: int) -> int:
        if contexts[i] is not None:
            return contexts[i].modulus
        if moduli is None:
            raise ValueError("row without context needs a modulus")
        return moduli[i]

    crt_idx: List[int] = []
    fb_idx: List[int] = []
    for i, (b, e, ctx) in enumerate(zip(bases, exps, contexts)):
        if ctx is None or e < 0 or math.gcd(b, ctx.modulus) != 1:
            fb_idx.append(i)
        else:
            crt_idx.append(i)

    out: List[Optional[int]] = [None] * rows
    if fb_idx:
        _count(fallback_rows=len(fb_idx))
        if fallback is None:
            for i in fb_idx:
                out[i] = pow(bases[i], exps[i], _mod(i))
        else:
            res = fallback(
                [bases[i] for i in fb_idx],
                [exps[i] for i in fb_idx],
                [_mod(i) for i in fb_idx],
            )
            for i, v in zip(fb_idx, res):
                out[i] = v
    if not crt_idx:
        return out  # type: ignore[return-value]

    r = _fresh_check_prime([bases[i] for i in crt_idx])
    r1 = r - 1

    # stage both legs of every row into ONE engine batch: [p-legs, q-legs]
    # grouped so equal-modulus runs stay consecutive for the native
    # engine's constants amortization
    leg_b: List[int] = []
    leg_e: List[int] = []
    leg_m: List[int] = []
    bits_saved = 0
    for leg in ("p", "q"):
        for i in crt_idx:
            ctx = contexts[i]
            leg_mod = (ctx.p_leg if leg == "p" else ctx.q_leg) * r
            d = ctx.d_p if leg == "p" else ctx.d_q
            # exponent reduced mod lcm(leg group order, r-1): valid for
            # bases coprime to leg and r (both guaranteed above)
            red = exps[i] % (d // math.gcd(d, r1) * r1)
            leg_b.append(bases[i] % leg_mod)
            leg_e.append(red)
            leg_m.append(leg_mod)
            bits_saved += max(
                0, ctx.modulus.bit_length() - leg_mod.bit_length()
            )
    _count(
        rows=len(crt_idx), legs=2 * len(crt_idx),
        fault_checks=2 * len(crt_idx), exp_bits_saved=bits_saved,
    )

    res = _leg_powm(leg_b, leg_e, leg_m)
    k = len(crt_idx)
    for j, i in enumerate(crt_idx):
        out[i] = _recombine_checked(
            bases[i], exps[i], r, res[j], res[k + j], contexts[i]
        )
    return out  # type: ignore[return-value]


def crt_powm_shared(
    base: int, exps: Sequence[int], ctx: CrtContext
) -> List[int]:
    """Fixed-base column base^exps[i] mod ctx.modulus via half-width
    comb legs — the ring-Pedersen M-round commitment shape (M=256 rows
    sharing one secret-owned modulus). Each leg runs the native one-shot
    comb (`native.modexp_shared`: the reduced base and its window table
    are factorization-derived, so they are built, used and wiped in one
    call, never cached) with the leg's squaring ladder paid once over all
    M rows; fault checks and Garner per row as in crt_modexp_batch."""
    m = len(exps)
    if m == 0:
        return []
    if math.gcd(base, ctx.modulus) != 1 or any(e < 0 for e in exps):
        _count(fallback_rows=m)
        from ..native import gmp

        return gmp.powm_batch([base] * m, list(exps), [ctx.modulus] * m, secret=True)

    r = _fresh_check_prime([base])
    r1 = r - 1
    from .. import native

    legs = []
    bits_saved = 0
    for leg_mod0, d in ((ctx.p_leg, ctx.d_p), (ctx.q_leg, ctx.d_q)):
        leg_mod = leg_mod0 * r
        lcm = d // math.gcd(d, r1) * r1
        red = [e % lcm for e in exps]
        bits_saved += m * max(
            0, ctx.modulus.bit_length() - leg_mod.bit_length()
        )
        legs.append(native.modexp_shared(base % leg_mod, red, leg_mod))
    _count(rows=m, legs=2 * m, fault_checks=2 * m, exp_bits_saved=bits_saved)
    return [
        _recombine_checked(base, e, r, sp, sq, ctx)
        for e, sp, sq in zip(exps, legs[0], legs[1])
    ]


def fault_checked_powm(base: int, exp: int, leg_mod: int) -> int:
    """One fault-checked HALF exponentiation: base^exp mod leg_mod,
    computed mod leg_mod*r and verified mod the fresh 64-bit prime r —
    the Paillier-decrypt shape, whose two legs carry DIFFERENT exponents
    (c^{p-1} mod p^2, c^{q-1} mod q^2) and are consumed separately by
    the L-function, so cross-leg agreement cannot apply; each leg is
    verified independently instead. Requires gcd(base, leg_mod) == 1;
    callers fall back to the unchecked path otherwise."""
    if exp < 0 or math.gcd(base, leg_mod) != 1:
        raise ValueError("fault_checked_powm needs a unit base, exp >= 0")
    r = _fresh_check_prime([base])
    (v,) = _leg_powm([base % (leg_mod * r)], [exp], [leg_mod * r])
    _count(legs=1, fault_checks=1)
    _check_leg(base, exp, r, v)
    return v % leg_mod
