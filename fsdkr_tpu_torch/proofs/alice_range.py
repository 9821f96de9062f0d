"""Alice's range proof: a Paillier ciphertext encrypts a value in the slack
range [0, q^3).

Re-derivation of the reference's `AliceProof`
(`src/range_proofs.rs:40-203`; GG19 Appendix-A MtA proof,
non-interactive via Fiat-Shamir). Notation matches the reference:

  prover (secret a < q, randomness r of c = Enc_ek(a, r)):
    alpha < q^3, beta <- Z_n^*, gamma < q^3*Ntilde, rho < q*Ntilde
    z = h1^a  h2^rho   mod Ntilde
    u = (1 + alpha*n) beta^n mod n^2          (= Enc(alpha, beta))
    w = h1^alpha h2^gamma mod Ntilde
    e = H(n, n+1, c, z, u, w)
    s = r^e beta mod n; s1 = e*a + alpha; s2 = e*rho + gamma

  verifier: reject if s1 > q^3; recompute
    w' = h1^s1 h2^s2 (z^e)^{-1} mod Ntilde
    u' = (1 + s1*n) s^n (c^e)^{-1} mod n^2
    accept iff H(n, n+1, c, z, u', w') == e
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..core import intops
from ..core.paillier import EncryptionKey
from ..core.secp256k1 import N as CURVE_ORDER
from ..core.transcript import Transcript
from .composite_dlog import DLogStatement

__all__ = ["AliceProof"]

_DOMAIN = b"fsdkr/alice-range/v1"


def _challenge(
    n: int, c: int, z: int, u: int, w: int, hash_alg: str | None = None
) -> int:
    # transcript fields mirror src/range_proofs.rs:150-157
    return (
        Transcript(_DOMAIN, algorithm=hash_alg)
        .chain_int(n)
        .chain_int(n + 1)
        .chain_int(c)
        .chain_int(z)
        .chain_int(u)
        .chain_int(w)
        .result_challenge()
    )


@dataclass(frozen=True)
class AliceProof:
    z: int
    e: int
    s: int
    s1: int
    s2: int

    @staticmethod
    def generate(
        a: int,
        cipher: int,
        alice_ek: EncryptionKey,
        dlog_statement: DLogStatement,
        r: int,
        q: int = CURVE_ORDER,
        hash_alg: str | None = None,
    ) -> "AliceProof":
        return AliceProof.generate_batch(
            [(a, cipher, alice_ek, dlog_statement, r)], q, hash_alg=hash_alg
        )[0]

    # Two-phase batched prover (same protocol as PDLwSlackProof's: stage1
    # emits columns, stage2 the response column) so distribute_batch can
    # fuse both families' same-width columns into shared launches.

    @staticmethod
    def sample_stage1(ntv, nv, q: int = CURVE_ORDER):
        """Input-independent stage-1 nonce sampling — the one sampler of
        the inline prover and the offline precompute producer (see
        PDLwSlackProof.sample_stage1). Returns (alpha, beta, gamma, rho)
        columns (this prover's sampling order: beta before gamma/rho)."""
        q3 = q**3
        alpha = [secrets.randbelow(q3) for _ in ntv]
        beta = [intops.sample_unit(n) for n in nv]
        gamma = [secrets.randbelow(q3 * nt) for nt in ntv]
        rho = [secrets.randbelow(q * nt) for nt in ntv]
        return alpha, beta, gamma, rho

    @staticmethod
    def produce_stage1(h1v, h2v, ntv, nv, powm=None, q: int = CURVE_ORDER):
        """Offline producer constructor: one stage-1 bundle per receiver
        environment (h1v[i], h2v[i], ntv[i], nv[i]) — (alpha, beta, rho,
        gamma, beta^n mod n^2, h2^rho mod N~, h1^alpha*h2^gamma mod N~),
        the 7-tuple shape of PDLwSlackProof.produce_stage1 (the two
        differ only in their beta distribution, kept by the samplers)."""
        if powm is None:
            from ..backend.powm import host_powm as powm
        from ..backend.powm import powm_columns

        nnv = [n * n for n in nv]
        alpha, beta, gamma, rho = AliceProof.sample_stage1(ntv, nv, q)
        h2rho, ca, cg, bn = powm_columns(
            powm,
            (h2v, rho, ntv),
            (h1v, alpha, ntv),
            (h2v, gamma, ntv),
            (beta, nv, nnv),
        )
        w = intops.mod_mul_col(ca, cg, ntv)
        return [
            (alpha[i], beta[i], rho[i], gamma[i], bn[i], h2rho[i], w[i])
            for i in range(len(nv))
        ]

    @staticmethod
    def generate_stage1(
        avals, rvals, h1v, h2v, ntv, nv, nnv, q: int = CURVE_ORDER,
        hash_alg: str | None = None, pooled=None,
    ):
        """Sample nonces, return (state, columns). Under FSDKRC_MULTIEXP
        z = h1^a h2^rho and w = h1^alpha h2^gamma are joint rows (see
        PDLwSlackProof.prove_stage1); off, the per-term column layout.
        CONTRACT: the beta^n mod n^2 column is LAST in every layout —
        distribute_batch splits it into the fused Paillier launch by
        position. `pooled` (FSDKRC_PRECOMPUTE): per-row Optional
        produce_stage1 bundles, as PDLwSlackProof.prove_stage1 takes
        them; only the witness factor h1^a stays online for pooled
        rows."""
        if q.bit_length() > 256:
            raise ValueError(
                "SHA-256 transcripts support group orders up to 256 bits"
            )
        from ..backend.powm import multiexp_enabled

        joint = multiexp_enabled()
        if pooled is not None:
            from .pdl_slack import _pooled_cols, _pooled_state

            state, fb = _pooled_state(
                lambda nts, ns: AliceProof.sample_stage1(nts, ns, q),
                ("alpha", "beta", "gamma", "rho"), pooled, ntv, nv,
            )
            state.update(avals=avals, rvals=rvals, ntv=ntv, nv=nv, nnv=nnv,
                         hash_alg=hash_alg, joint=joint)
            return state, _pooled_cols(state, fb, h1v, h2v, ntv, nv, nnv, avals, joint)
        alpha, beta, gamma, rho = AliceProof.sample_stage1(ntv, nv, q)
        state = dict(
            avals=avals, rvals=rvals, alpha=alpha, beta=beta,
            gamma=gamma, rho=rho, ntv=ntv, nv=nv, nnv=nnv,
            hash_alg=hash_alg, joint=joint,
        )
        if joint:
            cols = [
                (list(zip(h1v, h2v)), list(zip(avals, rho)), ntv),
                (list(zip(h1v, h2v)), list(zip(alpha, gamma)), ntv),
                (beta, nv, nnv),
            ]
        else:
            cols = [
                (h1v, avals, ntv),
                (h2v, rho, ntv),
                (h1v, alpha, ntv),
                (h2v, gamma, ntv),
                (beta, nv, nnv),
            ]
        return state, cols

    @staticmethod
    def generate_stage2(state, results, ciphers):
        ntv, nv, nnv = state["ntv"], state["nv"], state["nnv"]
        alpha = state["alpha"]
        from ..core import paillier

        if state.get("pooled_mode"):
            from .pdl_slack import _pooled_results

            z, w, bn = _pooled_results(state, results)
        elif state["joint"]:
            z, w, bn = results
        else:
            c1, c2, c3, c4, bn = results
            z = intops.mod_mul_col(c1, c2, ntv)
            w = intops.mod_mul_col(c3, c4, ntv)
        u = paillier.combine_with_rn(alpha, bn, nv, nnv)  # Enc(alpha; beta)
        e = [
            _challenge(n, cipher, zi, ui, wi, state["hash_alg"])
            for cipher, n, zi, ui, wi in zip(ciphers, nv, z, u, w)
        ]
        state.update(z=z, e=e)
        return state, [(state["rvals"], e, nv)]

    @staticmethod
    def generate_finish(state, results):
        (re_,) = results
        alpha, beta, rho, gamma = (
            state["alpha"], state["beta"], state["rho"], state["gamma"],
        )
        proofs = [
            AliceProof(
                z=zi,
                e=ei,
                s=x * b % n,
                s1=ei * a + al,
                s2=ei * ro + ga,
            )
            for a, n, zi, ei, x, b, al, ro, ga in zip(
                state["avals"], state["nv"], state["z"], state["e"], re_,
                beta, alpha, rho, gamma,
            )
        ]
        intops.zeroize_ints(alpha, beta, rho, gamma)
        return proofs

    @staticmethod
    def generate_batch(
        items, q: int = CURVE_ORDER, powm=None, hash_alg: str | None = None
    ) -> list["AliceProof"]:
        """Batched prover over items = [(a, cipher, ek, dlog_statement, r)].

        The per-receiver fan-out of distribute (reference
        `src/refresh_message.rs:106-116`) runs as six
        modexp columns (+ one post-challenge column) through `powm` —
        host pow or one device launch per column.
        """
        if powm is None:
            from ..backend.powm import host_powm as powm
        from ..backend.powm import powm_columns

        state, cols = AliceProof.generate_stage1(
            [a for a, *_ in items],
            [r for *_, r in items],
            [d.g for _, _, _, d, _ in items],
            [d.ni for _, _, _, d, _ in items],
            [d.N for _, _, _, d, _ in items],
            [ek.n for _, _, ek, _, _ in items],
            [ek.nn for _, _, ek, _, _ in items],
            q,
            hash_alg,
        )
        state, cols2 = AliceProof.generate_stage2(
            state, powm_columns(powm, *cols), [c for _, c, _, _, _ in items]
        )
        return AliceProof.generate_finish(state, powm_columns(powm, *cols2))

    @staticmethod
    def domain_gate(proof: "AliceProof", cipher: int,
                    dlog_statement: DLogStatement,
                    q: int = CURVE_ORDER) -> bool:
        """Wire-domain gate for one row of the batched verifier, applied
        BEFORE staging or hashing. s1's q^3 slack bound is the proof's
        own range gate (`src/range_proofs.rs:125`),
        enforced pre-launch; s2/e width caps are the honest-value bounds
        (s2 = e*rho + gamma < q^3 * N~ * 2^{small}); the remaining fields
        must be non-negative for chain_int / the limb encoder."""
        return (
            0 <= proof.s1 <= q**3
            and 0 <= proof.s2
            and proof.s2.bit_length() <= dlog_statement.N.bit_length() + 832
            and 0 <= proof.e < (1 << 256)
            and proof.z >= 0
            and proof.s >= 0
            and cipher >= 0
        )

    def verify(
        self,
        cipher: int,
        alice_ek: EncryptionKey,
        dlog_statement: DLogStatement,
        q: int = CURVE_ORDER,
        hash_alg: str | None = None,
    ) -> bool:
        h1, h2, n_tilde = dlog_statement.g, dlog_statement.ni, dlog_statement.N
        n, nn = alice_ek.n, alice_ek.nn

        # range gate (src/range_proofs.rs:125), plus
        # fail-closed domain gates for the remaining integers (negative
        # values would crash the transcript, not fail the proof)
        if self.s1 > q**3 or self.s1 < 0:
            return False
        if min(self.z, self.e, self.s, self.s2, cipher) < 0:
            return False

        z_e_inv = intops.mod_inv(intops.mod_pow(self.z, self.e, n_tilde), n_tilde)
        if z_e_inv is None:
            return False
        w = (
            intops.mod_pow(h1, self.s1, n_tilde)
            * intops.mod_pow(h2, self.s2, n_tilde)
            * z_e_inv
            % n_tilde
        )

        cipher_e_inv = intops.mod_inv(intops.mod_pow(cipher, self.e, nn), nn)
        if cipher_e_inv is None:
            return False
        gs1 = (1 + self.s1 * n) % nn
        u = gs1 * intops.mod_pow(self.s, n, nn) * cipher_e_inv % nn

        return _challenge(n, cipher, self.z, u, w, hash_alg) == self.e
