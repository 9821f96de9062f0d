"""Paillier cryptosystem (host oracle).

Capability surface of `kzen-paillier` as consumed by the reference:
`keypair_with_modulus_size(bits)`, encryption with chosen randomness
`(1+n)^m * r^n mod n^2`, homomorphic add and mul, CRT decryption with
`dk = {p, q}` (usage `src/refresh_message.rs:72-84,118,221-236,439`).
The batched r^n columns of distribute run on the device (backend.powm);
keygen (the native prime pipeline) and decryption (fault-checked CRT
legs on the native core, backend.crt) stay on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from . import intops, primes

__all__ = [
    "EncryptionKey",
    "DecryptionKey",
    "keygen",
    "keygen_batch",
    "encrypt",
    "encrypt_with_randomness",
    "combine_with_rn",
    "decrypt",
    "add",
    "mul",
    "sample_randomness",
]


@dataclass(frozen=True)
class EncryptionKey:
    """Public key; field names mirror the reference's `EncryptionKey{n, nn}`
    (`src/add_party_message.rs:248-251`)."""

    n: int
    nn: int

    @staticmethod
    def from_n(n: int) -> "EncryptionKey":
        return EncryptionKey(n=n, nn=n * n)


@dataclass
class DecryptionKey:
    """Secret key; `DecryptionKey{p, q}` as in the reference. Mutable so the
    protocol can zeroize it on refresh (`src/refresh_message.rs:446-448`)."""

    p: int
    q: int

    def zeroize(self) -> None:
        self.p = 0
        self.q = 0


def keygen(modulus_bits: int) -> tuple[EncryptionKey, DecryptionKey]:
    n, p, q = primes.gen_modulus(modulus_bits)
    return EncryptionKey.from_n(n), DecryptionKey(p=p, q=q)


def keygen_batch(
    modulus_bits: int, count: int
) -> list[tuple[EncryptionKey, DecryptionKey]]:
    """`count` fresh keypairs (the per-sender keygen of distribute_batch)."""
    return [
        (EncryptionKey.from_n(n), DecryptionKey(p=p, q=q))
        for n, p, q in primes.gen_moduli_batch(modulus_bits, count)
    ]


def sample_randomness(ek: EncryptionKey) -> int:
    return intops.sample_unit(ek.n)


def encrypt_with_randomness(ek: EncryptionKey, m: int, r: int) -> int:
    """c = (1+n)^m * r^n mod n^2, with (1+n)^m computed as 1 + m*n mod n^2.

    r must be a unit of Z_n; a zero / non-unit r would make the ciphertext
    undecryptable garbage rather than fail loudly.
    """
    if r <= 0 or math.gcd(r, ek.n) != 1:
        raise ValueError("Paillier randomness must be a unit of Z_n")
    gm = (1 + (m % ek.n) * ek.n) % ek.nn
    return (gm * intops.mod_pow(r, ek.n, ek.nn)) % ek.nn


def combine_with_rn(ms, rn, nv, nnv) -> list:
    """Assemble ciphertexts from a precomputed r^n column:
    c = (1 + (m mod n)*n) * r^n mod n^2. The one place the encryption
    formula lives — distribute's fused prover launch comes through here."""
    return [
        (1 + (m % n) * n) * x % nn for m, x, n, nn in zip(ms, rn, nv, nnv)
    ]


def encrypt(ek: EncryptionKey, m: int) -> int:
    return encrypt_with_randomness(ek, m, sample_randomness(ek))


def decrypt(dk: DecryptionKey, ek: EncryptionKey, c: int) -> int:
    """CRT decryption: m = L(c^lambda mod n^2) * lambda^{-1} mod n, done
    separately mod p^2 and q^2 and recombined. Each leg of a unit
    ciphertext runs through the secret-CRT engine's fault-checked path
    (backend.crt.fault_checked_powm): computed mod p^2*r for a fresh
    64-bit prime r and re-verified mod r, so a faulted leg aborts
    (CrtFaultError) instead of producing a wrong plaintext — the decrypt
    output feeds the refreshed key share, and the Bellcore gcd attack
    applies to a faulted CRT leg here as it does to RSA-CRT signatures."""
    p, q = dk.p, dk.q
    if p == 0 or q == 0:
        raise ValueError("decryption key has been zeroized")
    n = p * q
    pp, qq = p * p, q * q
    from ..backend import crt

    if math.gcd(c, n) == 1:
        cp_pow = crt.fault_checked_powm(c % pp, p - 1, pp)
        cq_pow = crt.fault_checked_powm(c % qq, q - 1, qq)
    else:  # a non-unit ciphertext: the unchecked legs
        cp_pow = intops.mod_pow(c % pp, p - 1, pp)
        cq_pow = intops.mod_pow(c % qq, q - 1, qq)
    # With g = 1+n: L_p(g^{p-1} mod p^2) = (p-1)*q mod p, so the CRT
    # correction factor is h_p = ((p-1)*q)^{-1} mod p (and symmetrically q).
    hp = pow((p - 1) * q % p, -1, p)
    hq = pow((q - 1) * p % q, -1, q)
    mp = ((cp_pow - 1) // p) * hp % p
    mq = ((cq_pow - 1) // q) * hq % q
    # CRT combine
    qinv = pow(q, -1, p)
    diff = (mp - mq) * qinv % p
    return (mq + diff * q) % n


def add(ek: EncryptionKey, c1: int, c2: int) -> int:
    """Homomorphic addition: Enc(m1) (+) Enc(m2) = c1*c2 mod n^2."""
    return (c1 * c2) % ek.nn


def mul(ek: EncryptionKey, c: int, k: int) -> int:
    """Homomorphic scalar multiplication: Enc(m) (*) k = c^k mod n^2."""
    return intops.mod_pow(c, k % ek.n, ek.nn)
