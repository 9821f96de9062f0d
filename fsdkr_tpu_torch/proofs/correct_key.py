"""Paillier correct-key proof: the prover knows the factorization of N and
N is a well-formed Paillier modulus.

Equivalent of zk-paillier's `NiCorrectKeyProof` (consumed by the reference
at `src/refresh_message.rs:119,375-384`; mechanism cited in
the reference README: Fiat-Shamir-derived group elements, prover returns
their N-th roots, verifier re-derives and checks sigma_i^N == rho_i mod N).

Details of this framework's instantiation:
- rho_i = MGF(N, salt, i) mod N, where MGF is SHA-256 counter-mode
  expansion to |N| + 128 bits (uniform mod N up to negligible bias).
- The prover computes sigma_i = rho_i^{N^{-1} mod phi} mod N — possible
  iff gcd(N, phi(N)) = 1, which holds for products of two distinct
  random primes with overwhelming probability.
- The verifier additionally rejects N with prime factors < 4000 and N
  even / too small, mirroring zk-paillier's small-factor gate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

from ..config import DEFAULT_CONFIG
from ..core import intops
from ..core.paillier import DecryptionKey, EncryptionKey
from ..core.primes import _PRIMORIAL
from ..core.transcript import Transcript

__all__ = ["NiCorrectKeyProof", "SALT_STRING"]

# Same role as zk-paillier's SALT_STRING constant (a public domain-separation
# salt for the challenge derivation).
SALT_STRING = b"fsdkr/correct-key/salt/v1"

_DOMAIN = b"fsdkr/correct-key/v1"


def _derive_rho(
    n: int, salt: bytes, index: int, hash_alg: str | None = None
) -> int:
    """Hash-expand (N, salt, index) to |N|+128 bits, reduce mod N."""
    need_bytes = (n.bit_length() + 127) // 8 + 16
    out = b""
    counter = 0
    while len(out) < need_bytes:
        out += (
            Transcript(_DOMAIN, algorithm=hash_alg)
            .chain_int(n)
            .chain_bytes(salt)
            .chain_int(index)
            .chain_int(counter)
            .result_bytes()
        )
        counter += 1
    return int.from_bytes(out[:need_bytes], "big") % n


@dataclass(frozen=True)
class NiCorrectKeyProof:
    sigma_vec: List[int]

    @staticmethod
    def derive_targets(
        n: int,
        salt: bytes = SALT_STRING,
        rounds: int = DEFAULT_CONFIG.correct_key_rounds,
        hash_alg: str | None = None,
    ) -> List[int]:
        """The Fiat-Shamir-derived group elements rho_i the prover must
        root — a pure function of the PUBLIC modulus (no prover nonces
        at all), shared by proof_batch and the batched verifier."""
        return [_derive_rho(n, salt, i, hash_alg) for i in range(rounds)]

    @staticmethod
    def proof(
        dk: DecryptionKey,
        salt: bytes = SALT_STRING,
        rounds: int = DEFAULT_CONFIG.correct_key_rounds,
        powm=None,
        hash_alg: str | None = None,
    ) -> "NiCorrectKeyProof":
        return NiCorrectKeyProof.proof_batch([dk], salt, rounds, powm, hash_alg)[0]

    @staticmethod
    def proof_batch(
        dks: List[DecryptionKey],
        salt: bytes = SALT_STRING,
        rounds: int = DEFAULT_CONFIG.correct_key_rounds,
        powm=None,
        hash_alg: str | None = None,
    ) -> List["NiCorrectKeyProof"]:
        """All provers' N-th-root columns in ONE modexp call (the
        cross-sender batch axis of a refresh). The exponent
        d = N^{-1} mod phi is secret. On the cuda backend the column
        rides the device's constant-time window loop; on the host engine
        the prover's own factorization sends it to the secret-CRT legs
        (backend.powm.crt_powm): d reduced mod p-1 / q-1 halves both the
        exponent and the width of each fault-checked leg on the native
        host core. The values are the same either way."""
        from ..backend.powm import crt_powm

        bases, exps, mods, factors = [], [], [], []
        for dk in dks:
            n = dk.p * dk.q
            phi = (dk.p - 1) * (dk.q - 1)
            d = pow(n, -1, phi)  # x -> x^d inverts x -> x^N on Z_N^*
            bases += NiCorrectKeyProof.derive_targets(n, salt, rounds, hash_alg)
            exps += [d] * rounds
            mods += [n] * rounds
            factors += [(dk.p, dk.q)] * rounds
        sigma = crt_powm(bases, exps, mods, factors, powm)
        return [
            NiCorrectKeyProof(sigma_vec=sigma[k * rounds : (k + 1) * rounds])
            for k in range(len(dks))
        ]

    @staticmethod
    def rlc_fold(sigma_vec, rho_targets, n: int, rhos):
        """Fold the per-round checks sigma_i^N == rho_i (mod N) into one
        Bellare-Garay-Rabin small-exponent RLC check

            (prod_i sigma_i^{rho_i})^N == prod_i rho_i^{rho_i}  (mod N)

        over the caller's secret fresh 128-bit coefficients (the shared
        exponent N factors out of the combination, so the proof's
        `rounds` full-width ladders collapse to ONE). Returns
        (sigma_row, target_row) joint multi-exponentiation rows riding
        short aggregated chains; the caller raises sigma_row's result to
        N — the single remaining full-width ladder — and compares.
        Domain gating (verify's parity/small-factor/range checks) must
        run BEFORE aggregation."""
        return (
            (tuple(sigma_vec), tuple(rhos), n),
            (tuple(rho_targets), tuple(rhos), n),
        )

    def verify(
        self,
        ek: EncryptionKey,
        salt: bytes = SALT_STRING,
        rounds: int = DEFAULT_CONFIG.correct_key_rounds,
        hash_alg: str | None = None,
    ) -> bool:
        n = ek.n
        if len(self.sigma_vec) != rounds:
            return False
        # small-factor / parity gate
        if n <= 0 or n % 2 == 0 or math.gcd(n, _PRIMORIAL) != 1:
            return False
        for i, sigma in enumerate(self.sigma_vec):
            if not (0 < sigma < n):
                return False
            if intops.mod_pow(sigma, n, n) != _derive_rho(n, salt, i, hash_alg):
                return False
        return True
