"""Prime generation for Paillier / ring-Pedersen moduli.

The reference delegates to GMP through `kzen-paillier`'s
`keypair_with_modulus_size` (`src/refresh_message.rs:118`). Here it is
GMP too (native/gmp.py): a small-prime sieve (one `gmp.gcd` against a
cached primorial) plus Miller-Rabin rounds on `gmp.powm`, a window of
candidates split over the host's cores. A single candidate
(`is_probable_prime`) takes the native core's Miller-Rabin. There is no
CPython path: a candidate the engines cannot take raises.
"""

from __future__ import annotations

import secrets

__all__ = [
    "is_probable_prime",
    "gen_prime",
    "gen_primes_batch",
    "gen_modulus",
    "gen_moduli_batch",
    "gen_stats",
    "gen_stats_reset",
]


def _primorial(limit: int = 4000) -> int:
    """Product of the odd primes below `limit`: one gcd against it rejects
    nearly all composites before any modexp is spent on Miller-Rabin."""
    sieve = bytearray([1]) * limit
    sieve[0:2] = b"\x00\x00"
    for i in range(2, int(limit**0.5) + 1):
        if sieve[i]:
            sieve[i * i :: i] = b"\x00" * len(sieve[i * i :: i])
    out = 1
    for p in range(3, limit):
        if sieve[p]:
            out *= p
    return out


# the verify-side small-factor gate (proofs.correct_key) uses this bound
_PRIMORIAL = _primorial()

# wider sieve for the GENERATION path only (rejects ~15% more composites
# before Miller-Rabin); the acceptance predicate keeps the 4000 bound
_WIDE_LIMIT = 1 << 14
_SIEVE_CACHE: dict = {}


def _sieve_for_bits(bits: int):
    """(primorial, its cached GMP operand) of the generation sieve for
    this candidate width. The bound lies strictly below the smallest
    candidate 3*2^(bits-2), or every prime in the range would be
    rejected as 'divides the primorial'. The primorial is public: its
    operand is never wiped (gmp.PublicOperand)."""
    bound = min(_WIDE_LIMIT, 3 << (bits - 2))
    ent = _SIEVE_CACHE.get(bound)
    if ent is None:
        from ..native import gmp

        prim = _primorial(bound)
        ent = _SIEVE_CACHE.setdefault(bound, (prim, gmp.PublicOperand(prim)))
    return ent


def _mr_rounds(n: int, rounds: int, powm=pow) -> bool:
    """Miller-Rabin rounds with CSPRNG witnesses over a powm engine
    (`gmp.powm` in the generation pipeline): the one copy of the
    witness, decomposition and squaring logic."""
    d = n - 1
    r = (d & -d).bit_length() - 1
    d >>= r
    for _ in range(rounds):
        a = 2 + secrets.randbelow(n - 3)
        x = powm(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def is_probable_prime(n: int, rounds: int = 30) -> bool:
    """Miller-Rabin with `rounds` random bases (error <= 4^-rounds), in
    the native core."""
    if n < 2:
        return False
    for small in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % small == 0:
            return n == small
    from .. import native

    return native.is_probable_prime(n, rounds)


def _gen_metric():
    from ..telemetry import registry

    return registry.counter(
        "fsdkr_primegen_events",
        "prime-search work drawn (candidates sieved / MR rounds requested)",
        labelnames=("event",),
    )


def gen_stats() -> dict:
    """Prime-search work drawn since the last gen_stats_reset(): the
    sieved candidates and the Miller-Rabin rounds requested (a keygen's
    time varies with the work drawn, so it is read per candidate)."""
    m = _gen_metric()
    return {
        "candidates": int(m.value(event="candidates")),
        "mr_rounds": int(m.value(event="mr_rounds")),
    }


def gen_stats_reset() -> None:
    _gen_metric().reset()


def _mr_batch(cands: list, rounds: int) -> list:
    """Miller-Rabin verdicts of a window of candidates: `_mr_rounds` on
    `gmp.powm`, the candidates split over the host's cores
    (`gmp.map_rows`; ctypes releases the GIL around each mpz_powm)."""
    from ..native import gmp

    return gmp.map_rows(lambda c: _mr_rounds(c, rounds, gmp.powm), cands)


def gen_primes_batch(bits: int, count: int) -> list:
    """`count` independent random primes with exactly `bits` bits and the
    top two bits set (see gen_prime for why). The pipeline is windowed:
    draw a window of independent CSPRNG candidates, reject by one gcd
    against the generation sieve, run ONE MR(1) batch over the window,
    then one 29-round confirmation batch over the survivors. The
    candidate distribution is the serial loop's: every candidate is an
    independent uniform draw, windows only change call granularity."""
    from ..native import gmp

    if bits < 8:
        raise ValueError("prime too small")
    sieve = _sieve_for_bits(bits)[1]
    found: list = []
    while len(found) < count:
        need = count - len(found)
        # ~bits/28 sieved survivors per prime expected; mild over-draw,
        # the loop refills on shortfall
        target = need * max(4, bits // 28 + 2)
        cands = []
        while len(cands) < target:
            c = secrets.randbits(bits) | (1 << (bits - 1)) | (1 << (bits - 2)) | 1
            if gmp.gcd(c, sieve) == 1:
                cands.append(c)
        gen = _gen_metric()
        gen.inc(len(cands), event="candidates")
        # one cheap round first: almost every sieved composite dies here
        gen.inc(len(cands), event="mr_rounds")
        survivors = [c for c, v in zip(cands, _mr_batch(cands, 1)) if v]
        if survivors:
            gen.inc(29 * len(survivors), event="mr_rounds")
            found += [c for c, v in zip(survivors, _mr_batch(survivors, 29)) if v]
    return found[:count]


def gen_prime(bits: int) -> int:
    """Random prime with exactly `bits` bits and the top two bits set.

    Forcing the two leading bits guarantees a product of two such primes has
    exactly 2*bits bits, satisfying the reference's moduli acceptance gate of
    [2*bits - 1, 2*bits] (`src/refresh_message.rs:385-391`).
    """
    return gen_primes_batch(bits, 1)[0]


def gen_moduli_batch(modulus_bits: int, count: int) -> list:
    """`count` moduli (n, p, q) with n = p*q of `modulus_bits` bits,
    p != q — all 2*count primes through one windowed pipeline."""
    if modulus_bits % 2:
        raise ValueError("modulus_bits must be even")
    half = modulus_bits // 2
    ps = gen_primes_batch(half, 2 * count)
    out = []
    for k in range(count):
        p, q = ps[2 * k], ps[2 * k + 1]
        while q == p:  # astronomically unlikely; regenerate q
            q = gen_prime(half)
        out.append((p * q, p, q))
    return out


def gen_modulus(modulus_bits: int) -> tuple[int, int, int]:
    """Generate (n, p, q) with n = p*q of `modulus_bits` bits, p != q."""
    return gen_moduli_batch(modulus_bits, 1)[0]
