"""Ring-Pedersen parameter proof: S = T^lambda mod N with T a square,
proven by an M-round binary-challenge sigma protocol, Fiat-Shamir batched.

Re-derivation of the reference's `RingPedersenProof`
(`src/ring_pedersen_proof.rs`; from the UC non-interactive
threshold-ECDSA paper). Challenge bits use the same Lsb0 digest-bit
semantics (`src/ring_pedersen_proof.rs:106,136`).

Conscious fix vs the reference (SURVEY.md §5 behavioral quirks): the
reference serializes the secret `phi` inside the broadcast statement
(`src/ring_pedersen_proof.rs:34` has no serde skip). Here `phi` lives in
the witness only; the wire statement is (S, T, N, ek).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import List

from ..config import ProtocolConfig, DEFAULT_CONFIG
from ..core import intops, primes
from ..core.paillier import EncryptionKey
from ..core.transcript import Transcript, challenge_bits
from ..errors import RingPedersenProofError

__all__ = ["RingPedersenStatement", "RingPedersenWitness", "RingPedersenProof"]

_DOMAIN = b"fsdkr/ring-pedersen/v1"


@dataclass(frozen=True)
class RingPedersenStatement:
    S: int
    T: int
    N: int
    ek: EncryptionKey

    @staticmethod
    def generate(
        config: ProtocolConfig = DEFAULT_CONFIG,
    ) -> tuple["RingPedersenStatement", "RingPedersenWitness"]:
        """Fresh modulus; T = r^2 mod N, S = T^lambda mod N
        (reference `src/ring_pedersen_proof.rs:48-74`)."""
        return RingPedersenStatement.generate_batch(1, config)[0]

    @staticmethod
    def generate_batch(
        count: int, config: ProtocolConfig = DEFAULT_CONFIG
    ) -> list:
        """`count` fresh statements: moduli through the windowed prime
        pipeline (core.primes, native Miller-Rabin batches), and
        S = T^lambda through the secret-CRT engine (backend.crt) — the
        prover owns this factorization, so the full-width ladder
        decomposes into two fault-checked half-width legs with lambda
        reduced mod p-1 / q-1, every statement's legs in one native
        batch (one row a statement, too few to fill a launch on the card).
        Same sampling order and values as the full-width path."""
        from ..backend import crt

        moduli = primes.gen_moduli_batch(config.paillier_bits, count)
        rows = []
        for n, p, q in moduli:
            phi = (p - 1) * (q - 1)
            r = secrets.randbelow(n)
            lam = secrets.randbelow(phi)
            rows.append((n, p, q, phi, lam, pow(r, 2, n)))
        s_vals = crt.crt_modexp_batch(
            [t for *_, t in rows], [lam for *_, lam, _ in rows],
            [crt.get_context(n, p, q) for n, p, q, *_ in rows],
        )
        return [
            (
                RingPedersenStatement(S=s, T=t, N=n, ek=EncryptionKey.from_n(n)),
                RingPedersenWitness(p=p, q=q, lam=lam, phi=phi),
            )
            for (n, p, q, phi, lam, t), s in zip(rows, s_vals)
        ]


@dataclass(frozen=True)
class RingPedersenWitness:
    p: int
    q: int
    lam: int
    phi: int


@dataclass(frozen=True)
class RingPedersenProof:
    A: List[int]
    Z: List[int]

    @staticmethod
    def _challenge(a_vec: List[int], hash_alg: str | None = None) -> int:
        t = Transcript(_DOMAIN, algorithm=hash_alg)
        for a_i in a_vec:
            t.chain_int(a_i)
        return t.result_int()

    @staticmethod
    def prove(
        witness: RingPedersenWitness,
        st: RingPedersenStatement,
        m_security: int = DEFAULT_CONFIG.m_security,
        powm=None,
        hash_alg: str | None = None,
    ) -> "RingPedersenProof":
        return RingPedersenProof.prove_batch(
            [witness], [st], m_security, powm, hash_alg
        )[0]

    @staticmethod
    def sample_commit(
        witnesses: List[RingPedersenWitness],
        m_security: int = DEFAULT_CONFIG.m_security,
    ) -> List[List[int]]:
        """M-round commitment nonces a_i < phi per witness — the one
        sampler of the inline prover and the key-material producer
        (precompute), so pooled and inline runs draw alike."""
        return [
            [secrets.randbelow(w.phi) for _ in range(m_security)]
            for w in witnesses
        ]

    @staticmethod
    def prove_batch(
        witnesses: List[RingPedersenWitness],
        statements: List[RingPedersenStatement],
        m_security: int = DEFAULT_CONFIG.m_security,
        powm=None,
        hash_alg: str | None = None,
    ) -> List["RingPedersenProof"]:
        """All provers' M-round commitment columns. The proof depends on
        (witness, statement) alone — the challenge binds only the
        prover's own commitments — so whole proofs are input-independent
        and ride the precompute key-material pool with their statements.

        On the cuda backend, ONE modexp launch through `powm`, each
        prover's rows sharing (T, N) for the card's comb. On the host
        engine the prover's own factorization splits the M rows
        T^{a_i} mod N into two fault-checked half-width fixed-base comb
        legs a prover on the native host core (exponents reduced mod
        p-1 / q-1, one squaring ladder a leg over all M rows, tables
        built, used and wiped), which beat CPython's full-width pow. The
        A values are the same either way."""
        from ..backend.powm import host_powm

        if powm is None:
            powm = host_powm
        if len(witnesses) != len(statements):
            raise ValueError(
                f"batch length mismatch: {len(witnesses)} witnesses, "
                f"{len(statements)} statements"
            )
        a_all = RingPedersenProof.sample_commit(witnesses, m_security)
        from ..backend import crt

        if powm is host_powm:
            A_all = []
            for w, st, a_vec in zip(witnesses, statements, a_all):
                A_all += crt.crt_powm_shared(
                    st.T, a_vec, crt.get_context(st.N, w.p, w.q)
                )
        else:
            A_all = powm(
                [st.T for st in statements for _ in range(m_security)],
                [a for grp in a_all for a in grp],
                [st.N for st in statements for _ in range(m_security)],
            )
        out = []
        for k, (witness, a_vec) in enumerate(zip(witnesses, a_all)):
            A_vec = A_all[k * m_security : (k + 1) * m_security]
            e = RingPedersenProof._challenge(A_vec, hash_alg)
            bits = challenge_bits(e, m_security, hash_alg)
            Z_vec = [
                (a_i + (witness.lam if b else 0)) % witness.phi
                for a_i, b in zip(a_vec, bits)
            ]
            out.append(RingPedersenProof(A=A_vec, Z=Z_vec))
        intops.zeroize_ints(*a_all)  # drop the commitment nonces
        return out

    @staticmethod
    def rlc_fold(st: "RingPedersenStatement", proof: "RingPedersenProof",
                 bits, rhos):
        """Fold the M binary-challenge rows T^{Z_i} == A_i * S^{e_i}
        (mod N) into one Bellare-Garay-Rabin small-exponent RLC check

            T^{sum_i rho_i Z_i} == prod_i A_i^{rho_i} * S^{sum_{e_i=1} rho_i}

        over the caller's secret fresh rho_i (backend.rlc). Both sides
        are products of non-negative powers (no inversions), so the fold
        is evaluated as an equality of two computed elements. Returns
        (lhs_row, rhs_row) as (bases, exps, modulus) joint
        multi-exponentiation rows: lhs is the proof's ONE remaining
        full-width ladder (T's per-row exponents merge into a single
        ~|N|+136-bit exponent); rhs rides a short aggregated chain — M+1
        terms whose exponents are only 128-136 bits wide. Domain gating
        (verify's shape/range checks) must run BEFORE aggregation: the
        caller folds only in-domain proofs."""
        e_merged = sum(r * z for r, z in zip(rhos, proof.Z))
        e_s = sum(r for r, b in zip(rhos, bits) if b)
        lhs = ((st.T,), (e_merged,), st.N)
        rhs = (tuple(proof.A) + (st.S,), tuple(rhos) + (e_s,), st.N)
        return lhs, rhs

    def verify(
        self,
        st: RingPedersenStatement,
        m_security: int = DEFAULT_CONFIG.m_security,
        hash_alg: str | None = None,
    ) -> None:
        """Per-bit check T^{Z_i} == A_i * S^{e_i} mod N
        (reference `src/ring_pedersen_proof.rs:138-155`)."""
        if len(self.A) != m_security or len(self.Z) != m_security:
            raise RingPedersenProofError()
        # fail closed on out-of-domain integers (in-process objects; the
        # wire decode is strict): negatives crash transcript/pow paths
        if st.N <= 2 or any(a < 0 for a in self.A) or any(z < 0 for z in self.Z):
            raise RingPedersenProofError()
        e = RingPedersenProof._challenge(self.A, hash_alg)
        bits = challenge_bits(e, m_security, hash_alg)
        for a_i, z_i, b in zip(self.A, self.Z, bits):
            lhs = intops.mod_pow(st.T, z_i, st.N)
            rhs = a_i * (st.S if b else 1) % st.N
            if lhs != rhs:
                raise RingPedersenProofError()
