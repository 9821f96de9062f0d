"""Arbitrary-precision integer helpers over CPython ints.

The `curv::BigInt` operation surface the reference consumes: mod_pow /
mod_inv / mod_mul / sampling / byte conversion (usage sites e.g.
`src/range_proofs.rs:54-63`, `src/zk_pdl_with_slack.rs:177-187`).
Wide odd-modulus exponentiation runs in the system GMP (native/gmp.py,
the reference's own bigint backend); batched columns go to the device
(backend.powm).
"""

from __future__ import annotations

import math
import secrets

__all__ = [
    "mod_pow",
    "mod_pow_signed",
    "mod_inv",
    "mod_mul",
    "mod_mul_col",
    "sample_below",
    "sample_range",
    "sample_bits",
    "sample_unit",
    "bit_length",
    "to_bytes",
    "from_bytes",
    "gcd",
]


# below this, the bridge's staging costs more than GMP wins over pow
_NATIVE_POW_MIN_BITS = 1024
_gmp = None


def mod_pow(base: int, exp: int, modulus: int) -> int:
    """base^exp mod modulus for exp >= 0: `gmp.powm` for odd moduli of
    `_NATIVE_POW_MIN_BITS` and up, CPython pow below them."""
    global _gmp
    if exp >= 0 and modulus & 1 and modulus.bit_length() >= _NATIVE_POW_MIN_BITS:
        if _gmp is None:
            from ..native import gmp

            _gmp = gmp
        return _gmp.powm(base, exp, modulus)
    return pow(base, exp, modulus)


def mod_pow_signed(base: int, exp: int, modulus: int) -> int:
    """base^exp mod modulus, handling negative exponents via modular inverse.

    Mirrors the negative-exponent branch of `commitment_unknown_order`
    (`src/zk_pdl_with_slack.rs:178-185`).
    """
    if exp < 0:
        inv = mod_inv(base, modulus)
        if inv is None:
            raise ValueError("base not invertible for negative exponent")
        return mod_pow(inv, -exp, modulus)
    return mod_pow(base, exp, modulus)


def mod_inv(x: int, modulus: int):
    """Modular inverse, or None when gcd(x, modulus) != 1 (the reference's
    `BigInt::mod_inv` returns Option)."""
    try:
        return pow(x, -1, modulus)
    except ValueError:
        return None


def mod_mul(a: int, b: int, modulus: int) -> int:
    return (a * b) % modulus


def mod_mul_col(a, b, moduli) -> list:
    """Row-wise a[i]*b[i] mod moduli[i] — the commitment pair-combine of
    the staged provers (z = c1*c2, u3/w = c3*c4 over unknown-order Z_N~)."""
    return [x * y % m for x, y, m in zip(a, b, moduli)]


def sample_below(bound: int) -> int:
    """Uniform sample in [0, bound)."""
    if bound <= 0:
        raise ValueError("bound must be positive")
    return secrets.randbelow(bound)


def sample_range(lo: int, hi: int) -> int:
    """Uniform sample in [lo, hi)."""
    return lo + secrets.randbelow(hi - lo)


def sample_bits(bits: int) -> int:
    return secrets.randbits(bits)


def sample_unit(modulus: int) -> int:
    """Uniform sample from the multiplicative group Z_modulus^* (rejection
    sampling, reference `SampleFromMultiplicativeGroup`
    `src/range_proofs.rs:598-612`)."""
    while True:
        r = secrets.randbelow(modulus)
        if r and math.gcd(r, modulus) == 1:
            return r


def bit_length(x: int) -> int:
    return x.bit_length()


def to_bytes(x: int) -> bytes:
    """Minimal big-endian magnitude bytes; 0 encodes as b'' (matching the
    transcript convention in core.transcript)."""
    if x < 0:
        raise ValueError("to_bytes takes non-negative integers")
    return x.to_bytes((x.bit_length() + 7) // 8, "big")


def from_bytes(b: bytes) -> int:
    return int.from_bytes(b, "big")


def gcd(a: int, b: int) -> int:
    return math.gcd(a, b)


def zeroize_ints(*lists) -> None:
    """Drop proof-nonce references as soon as the proof is assembled
    (the reference zeroizes its ZKP round state,
    `src/range_proofs.rs:28-29,222-243`). Python ints are immutable, so
    clearing the containers releases the only references."""
    for lst in lists:
        lst.clear()
