"""PDL-with-slack proof: a Paillier ciphertext c = Enc_ek(x, r) and an EC
point Q = x*G hide the same x, with range slack x in [-q^3, q^3].

Re-derivation of the reference's `PDLwSlackProof`
(`src/zk_pdl_with_slack.rs`, following eprint 2016/013 PIi):

  prover (witness x < q, r):
    alpha < q^3, beta <- [1, n), rho < q*Ntilde, gamma < q^3*Ntilde
    z  = h1^x h2^rho mod Ntilde
    u1 = alpha * G
    u2 = (1+n)^alpha beta^n mod n^2
    u3 = h1^alpha h2^gamma mod Ntilde
    e  = H(G, Q, c, z, u1, u2, u3)
    s1 = e*x + alpha;  s2 = r^e beta mod n;  s3 = e*rho + gamma

  verifier: recompute e; accept iff
    u1 == s1*G - e*Q
    u2 == (1+n)^s1 s2^n c^{-e} mod n^2
    u3 == h1^s1 h2^s3 z^{-e} mod Ntilde
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..core import intops
from ..core.paillier import EncryptionKey
from ..core.secp256k1 import N as CURVE_ORDER
from ..core.secp256k1 import GENERATOR, Point, Scalar
from ..core.transcript import Transcript
from ..errors import PDLwSlackProofError

__all__ = ["PDLwSlackStatement", "PDLwSlackWitness", "PDLwSlackProof", "commitment_unknown_order"]

_DOMAIN = b"fsdkr/pdl-slack/v1"


def commitment_unknown_order(h1: int, h2: int, modulus: int, x: int, r: int) -> int:
    """h1^x * h2^r mod modulus over a group of unknown order; negative
    exponents via modular inverse (reference
    `src/zk_pdl_with_slack.rs:170-188`)."""
    return (
        intops.mod_pow_signed(h1, x, modulus)
        * intops.mod_pow_signed(h2, r, modulus)
        % modulus
    )


@dataclass(frozen=True)
class PDLwSlackStatement:
    # field set mirrors src/zk_pdl_with_slack.rs:24-32
    ciphertext: int
    ek: EncryptionKey
    Q: Point
    G: Point
    h1: int
    h2: int
    N_tilde: int


@dataclass(frozen=True)
class PDLwSlackWitness:
    x: Scalar
    r: int


@dataclass(frozen=True)
class PDLwSlackProof:
    z: int
    u1: Point
    u2: int
    u3: int
    s1: int
    s2: int
    s3: int

    @staticmethod
    def _challenge(
        st: PDLwSlackStatement, z: int, u1: Point, u2: int, u3: int,
        hash_alg: str | None = None,
    ) -> int:
        # transcript fields mirror src/zk_pdl_with_slack.rs:87-95
        return (
            Transcript(_DOMAIN, algorithm=hash_alg)
            .chain_point(st.G)
            .chain_point(st.Q)
            .chain_int(st.ciphertext)
            .chain_int(z)
            .chain_point(u1)
            .chain_int(u2)
            .chain_int(u3)
            .result_challenge()
        )

    @staticmethod
    def prove(
        witness: PDLwSlackWitness,
        st: PDLwSlackStatement,
        hash_alg: str | None = None,
    ) -> "PDLwSlackProof":
        return PDLwSlackProof.prove_batch([witness], [st], hash_alg=hash_alg)[0]

    # Two-phase batched prover: stage1 emits the modexp columns of the
    # round-1 commitments, stage2 (after the fused launch) emits the
    # response column. distribute_batch drives the PDL and Alice-range
    # provers (and the encryption column) in lockstep so same-width
    # columns of BOTH families share one launch — sequential modexp
    # depth, not row count, prices a launch (backend.powm.powm_columns).

    @staticmethod
    def sample_stage1(ntv, nv):
        """Input-independent stage-1 nonce sampling for len(ntv) rows —
        the one sampler of the inline prover and the offline precompute
        producer, so pooled and inline runs draw from identical
        distributions in identical per-row order. Returns (alpha, beta,
        rho, gamma) columns."""
        q = CURVE_ORDER
        q3 = q**3
        alpha = [secrets.randbelow(q3) for _ in ntv]
        beta = [1 + secrets.randbelow(n - 1) for n in nv]
        rho = [secrets.randbelow(q * nt) for nt in ntv]
        gamma = [secrets.randbelow(q3 * nt) for nt in ntv]
        return alpha, beta, rho, gamma

    @staticmethod
    def produce_stage1(h1v, h2v, ntv, nv, powm=None):
        """Offline producer constructor (precompute): sample one row of
        stage-1 nonces per receiver environment (h1v[i], h2v[i], ntv[i],
        nv[i]) and evaluate every input-independent power through `powm`
        (host pow when omitted). The JAX package takes one environment
        and a count; the port's producer batches many environments into
        one set of columns. Returns pool bundles (alpha, beta, rho,
        gamma, beta^n mod n^2, h2^rho mod N~, h1^alpha*h2^gamma mod N~)
        — the values prove_stage1 samples and computes inline (same
        sampler, same arithmetic). The witness-dependent factor h1^x and
        everything after the Fiat-Shamir challenge stay online."""
        if powm is None:
            from ..backend.powm import host_powm as powm
        from ..backend.powm import powm_columns

        nnv = [n * n for n in nv]
        alpha, beta, rho, gamma = PDLwSlackProof.sample_stage1(ntv, nv)
        h2rho, ca, cg, bn = powm_columns(
            powm,
            (h2v, rho, ntv),
            (h1v, alpha, ntv),
            (h2v, gamma, ntv),
            (beta, nv, nnv),
        )
        u3 = intops.mod_mul_col(ca, cg, ntv)
        return [
            (alpha[i], beta[i], rho[i], gamma[i], bn[i], h2rho[i], u3[i])
            for i in range(len(nv))
        ]

    @staticmethod
    def prove_stage1(witnesses, h1v, h2v, ntv, nv, nnv, hash_alg=None,
                     pooled=None):
        """Sample nonces, return (state, columns). Under FSDKRC_MULTIEXP
        (backend.powm.multiexp_enabled) the two mod-N~ commitments are
        joint rows, z = h1^x h2^rho and u3 = h1^alpha h2^gamma, which the
        planner (backend.powm.multi_powm) computes and multiplies back
        itself; off, the per-term column layout. CONTRACT: the beta^n mod
        n^2 column is LAST in every layout — distribute_batch splits it
        into the fused Paillier launch by position.

        `pooled` (FSDKRC_PRECOMPUTE): a per-row list of Optional
        produce_stage1 bundles. Pooled rows contribute NO offline
        columns — only the witness factor h1^x remains (one column over
        all rows, which powm_columns shares with the Alice prover's
        identical share column); rows with a dry pool (None) ride
        fallback columns with the inline values."""
        from ..backend.powm import multiexp_enabled

        joint = multiexp_enabled()
        if pooled is None:
            alpha, beta, rho, gamma = PDLwSlackProof.sample_stage1(ntv, nv)
            state = dict(
                witnesses=witnesses, alpha=alpha, beta=beta, rho=rho,
                gamma=gamma, ntv=ntv, nv=nv, nnv=nnv, hash_alg=hash_alg,
                joint=joint,
            )
            if joint:
                cols = [
                    (list(zip(h1v, h2v)),
                     [(w.x.to_int(), r) for w, r in zip(witnesses, rho)], ntv),
                    (list(zip(h1v, h2v)), list(zip(alpha, gamma)), ntv),
                    (beta, nv, nnv),
                ]
            else:
                cols = [
                    (h1v, [w.x.to_int() for w in witnesses], ntv),
                    (h2v, rho, ntv),
                    (h1v, alpha, ntv),
                    (h2v, gamma, ntv),
                    (beta, nv, nnv),
                ]
            return state, cols

        state, fb = _pooled_state(
            PDLwSlackProof.sample_stage1, ("alpha", "beta", "rho", "gamma"),
            pooled, ntv, nv,
        )
        state.update(witnesses=witnesses, ntv=ntv, nv=nv, nnv=nnv,
                     hash_alg=hash_alg, joint=joint)
        cols = _pooled_cols(
            state, fb, h1v, h2v, ntv, nv, nnv,
            [w.x.to_int() for w in witnesses], joint,
        )
        return state, cols

    @staticmethod
    def prove_stage2(state, results, statements, device=None):
        """Combine stage-1 results, recompute challenges, return
        (state, columns): the r^e response column. u1 = alpha*G: one
        `generator_muls` call on `device` (the caller's torch device, or
        None for the host) when every statement's G is the generator,
        else per row on the host."""
        ntv, nv, nnv = state["ntv"], state["nv"], state["nnv"]
        alpha = state["alpha"]
        from ..core import paillier

        if state.get("pooled_mode"):
            z, u3, bn = _pooled_results(state, results)
        elif state["joint"]:
            z, u3, bn = results
        else:
            c1, c2, c3, c4, bn = results
            z = intops.mod_mul_col(c1, c2, ntv)
            u3 = intops.mod_mul_col(c3, c4, ntv)
        u2 = paillier.combine_with_rn(alpha, bn, nv, nnv)  # Enc(alpha; beta)
        if all(st.G == GENERATOR for st in statements):
            from ..ops.ec_batch import generator_muls

            u1 = generator_muls(alpha, device)
        else:
            u1 = [st.G * Scalar.from_int(al) for st, al in zip(statements, alpha)]
        e = [
            PDLwSlackProof._challenge(st, zi, u1i, u2i, u3i, state["hash_alg"])
            for st, zi, u1i, u2i, u3i in zip(statements, z, u1, u2, u3)
        ]
        state.update(z=z, u1=u1, u2=u2, u3=u3, e=e)
        return state, [([w.r for w in state["witnesses"]], e, nv)]

    @staticmethod
    def prove_finish(state, results):
        (re_,) = results
        alpha, beta, rho, gamma = (
            state["alpha"], state["beta"], state["rho"], state["gamma"],
        )
        proofs = [
            PDLwSlackProof(
                z=zi,
                u1=u1i,
                u2=u2i,
                u3=u3i,
                s1=ei * w.x.to_int() + al,
                s2=x * b % n,
                s3=ei * ro + ga,
            )
            for w, n, zi, u1i, u2i, u3i, ei, x, b, al, ro, ga in zip(
                state["witnesses"], state["nv"], state["z"], state["u1"],
                state["u2"], state["u3"], state["e"], re_, beta, alpha, rho,
                gamma,
            )
        ]
        intops.zeroize_ints(alpha, beta, rho, gamma)
        return proofs

    @staticmethod
    def prove_batch(
        witnesses: list[PDLwSlackWitness],
        statements: list[PDLwSlackStatement],
        powm=None,
        hash_alg: str | None = None,
    ) -> list["PDLwSlackProof"]:
        """Batched prover: the n-receiver fan-out of distribute (reference
        `src/refresh_message.rs:87-104`) as modexp columns
        through `powm` (host pow or one device launch per column).

        (1+n)^alpha mod n^2 uses the closed form 1 + (alpha mod n)*n, so
        the u2 column needs only the beta^n exponentiation.
        """
        if powm is None:
            from ..backend.powm import host_powm as powm
        if len(witnesses) != len(statements):
            raise ValueError(
                f"batch length mismatch: {len(witnesses)} witnesses, "
                f"{len(statements)} statements"
            )
        from ..backend.powm import powm_columns

        state, cols = PDLwSlackProof.prove_stage1(
            witnesses,
            [st.h1 for st in statements],
            [st.h2 for st in statements],
            [st.N_tilde for st in statements],
            [st.ek.n for st in statements],
            [st.ek.nn for st in statements],
            hash_alg,
        )
        state, cols2 = PDLwSlackProof.prove_stage2(
            state, powm_columns(powm, *cols), statements
        )
        return PDLwSlackProof.prove_finish(state, powm_columns(powm, *cols2))

    @staticmethod
    def domain_gate(proof: "PDLwSlackProof", st: PDLwSlackStatement,
                    q: int = CURVE_ORDER) -> bool:
        """Wire-domain gate for one row of the batched verifier, applied
        BEFORE any staging, hashing, or aggregation. Exponent-position
        fields (s1, s3) are attacker-chosen integers: a negative value
        would crash the limb encoder mid-batch and an oversized one would
        inflate a whole fused launch's exponent width — a one-row DoS.
        Width caps
        are the honest-value bounds: s1 = e*x + alpha < 2q^3 (832 bits of
        slack used), s3 = e*rho + gamma < 2q^3 * N_tilde.
        Transcript-position fields (z, u2, u3, ciphertext) must be
        non-negative for chain_int."""
        q3 = q**3
        return (
            proof.z >= 0
            and proof.u2 >= 0
            and proof.u3 >= 0
            and st.ciphertext >= 0
            and 0 <= proof.s1 <= 2 * q3
            and 0 <= proof.s3
            and proof.s3.bit_length() <= st.N_tilde.bit_length() + 832
        )

    @staticmethod
    def rlc_fold_nt(h1: int, h2: int, n_tilde: int, rows, rhos):
        """Fold the mod-N~ equations u3_j * z_j^{e_j} == h1^{s1_j} h2^{s3_j}
        of the rows sharing one receiver statement (h1, h2, N~) into one
        Bellare-Garay-Rabin small-exponent RLC check

            h1^{sum rho_j s1_j} * h2^{sum rho_j s3_j}
                == prod_j u3_j^{rho_j} * prod_j z_j^{rho_j e_j}  (mod N~)

        rows: [(z, u3, e, s1, s3)] per proof, already domain-gated.
        Returns (lhs_row, rhs_row) joint multi-exponentiation rows: the
        shared bases h1/h2 merge their exponents into lhs's single
        full-width 2-term ladder; the per-row bases keep only short
        (128/384-bit) exponents on rhs's aggregated chain."""
        s1_merged = sum(r * s1 for r, (_, _, _, s1, _) in zip(rhos, rows))
        s3_merged = sum(r * s3 for r, (_, _, _, _, s3) in zip(rhos, rows))
        lhs = ((h1, h2), (s1_merged, s3_merged), n_tilde)
        rhs = (
            tuple(u3 for _, u3, _, _, _ in rows)
            + tuple(z for z, _, _, _, _ in rows),
            tuple(rhos)
            + tuple(r * e for r, (_, _, e, _, _) in zip(rhos, rows)),
            n_tilde,
        )
        return lhs, rhs

    @staticmethod
    def rlc_fold_nn(n: int, nn: int, rows, rhos):
        """Fold the mod-n^2 equations u2_j * c_j^{e_j} == (1+n)^{s1_j} s2_j^n
        of the rows sharing one receiver Paillier key into

            prod_j u2_j^{rho_j} * prod_j c_j^{rho_j e_j}
                == (1 + (sum rho_j s1_j) n) * (prod_j s2_j^{rho_j})^n  (mod n^2)

        rows: [(u2, c, e, s1, s2)] per proof, already domain-gated.
        (1+n)^x has the closed form 1 + (x mod n) n, so the whole
        combined g-term costs one host multiply. Returns (s2_row,
        commit_row, gs1): s2_row aggregates prod s2_j^{rho_j} on a short
        chain — the caller raises its result to n, the group's single
        remaining full-width ladder — and commit_row aggregates the
        u2/c side; gs1 is the closed-form combined (1+n)-power."""
        s2_row = (
            tuple(s2 for _, _, _, _, s2 in rows),
            tuple(rhos),
            nn,
        )
        commit_row = (
            tuple(u2 for u2, _, _, _, _ in rows)
            + tuple(c for _, c, _, _, _ in rows),
            tuple(rhos)
            + tuple(r * e for r, (_, _, e, _, _) in zip(rhos, rows)),
            nn,
        )
        s1_merged = sum(
            r * (s1 % n) for r, (_, _, _, s1, _) in zip(rhos, rows)
        )
        gs1 = (1 + (s1_merged % n) * n) % nn
        return s2_row, commit_row, gs1

    def verify(self, st: PDLwSlackStatement, hash_alg: str | None = None) -> None:
        """Raises PDLwSlackProofError with per-equation booleans on failure
        (reference `src/zk_pdl_with_slack.rs:158-166`).

        Out-of-domain integers (negative proof fields or ciphertext —
        possible for in-process objects; the wire decode is strict) fail
        closed with the proof error instead of crashing the transcript."""
        if (
            min(self.z, self.u2, self.u3, self.s1, self.s2, self.s3) < 0
            or st.ciphertext < 0
        ):
            raise PDLwSlackProofError(False, False, False)
        e = PDLwSlackProof._challenge(
            st, self.z, self.u1, self.u2, self.u3, hash_alg
        )

        g_s1 = st.G * Scalar.from_int(self.s1)
        e_neg = Scalar.from_int(CURVE_ORDER - e % CURVE_ORDER)
        u1_test = g_s1 + st.Q * e_neg

        u2_test_tmp = commitment_unknown_order(
            st.ek.n + 1, self.s2, st.ek.nn, self.s1, st.ek.n
        )
        u2_test = commitment_unknown_order(u2_test_tmp, st.ciphertext, st.ek.nn, 1, -e)

        u3_test_tmp = commitment_unknown_order(
            st.h1, st.h2, st.N_tilde, self.s1, self.s3
        )
        u3_test = commitment_unknown_order(u3_test_tmp, self.z, st.N_tilde, 1, -e)

        ok1, ok2, ok3 = self.u1 == u1_test, self.u2 == u2_test, self.u3 == u3_test
        if not (ok1 and ok2 and ok3):
            raise PDLwSlackProofError(ok1, ok2, ok3)


# ---------------------------------------------------------------------------
# The pooled stage-1 layout, shared with proofs.alice_range: both provers'
# pool bundles are (alpha, beta, rho, gamma, beta^n, h2^rho,
# h1^alpha h2^gamma), and both commit h1^w h2^rho and h1^alpha h2^gamma.


def _pooled_state(sampler, names, pooled, ntv, nv):
    """Nonce columns of a pooled stage 1: pooled rows from their bundles,
    dry rows (None) from `sampler` over those rows alone (its columns
    named by `names`, in its order). Returns (state, fb): the state with
    the nonce columns and the bundles' powers, and the dry rows."""
    rows = len(ntv)
    fb = [i for i in range(rows) if pooled[i] is None]
    sampled = dict(zip(names, sampler([ntv[i] for i in fb], [nv[i] for i in fb])))
    cols = {k: [0] * rows for k in ("alpha", "beta", "rho", "gamma")}
    pool_bn, pool_h2rho, pool_u3 = {}, {}, {}
    for i, p in enumerate(pooled):
        if p is not None:
            (cols["alpha"][i], cols["beta"][i], cols["rho"][i], cols["gamma"][i],
             pool_bn[i], pool_h2rho[i], pool_u3[i]) = p
    for j, i in enumerate(fb):
        for k in cols:
            cols[k][i] = sampled[k][j]
    state = dict(cols, pooled_mode=True, fb=fb, pool_bn=pool_bn,
                 pool_h2rho=pool_h2rho, pool_u3=pool_u3)
    return state, fb


def _pooled_cols(state, fb, h1v, h2v, ntv, nv, nnv, wit, joint):
    """Stage-1 columns of a pooled stage 1: h1^wit over every row, then
    the dry rows' h2^rho, h1^alpha h2^gamma (one joint column, or two)
    and, LAST, beta^n mod n^2."""
    alpha, gamma, rho, beta = (state[k] for k in ("alpha", "gamma", "rho", "beta"))
    nt_fb = [ntv[i] for i in fb]
    if joint:
        u3_cols = [(
            [(h1v[i], h2v[i]) for i in fb],
            [(alpha[i], gamma[i]) for i in fb],
            nt_fb,
        )]
    else:
        u3_cols = [
            ([h1v[i] for i in fb], [alpha[i] for i in fb], nt_fb),
            ([h2v[i] for i in fb], [gamma[i] for i in fb], nt_fb),
        ]
    return [
        (h1v, wit, ntv),
        ([h2v[i] for i in fb], [rho[i] for i in fb], nt_fb),
        *u3_cols,
        ([beta[i] for i in fb], [nv[i] for i in fb], [nnv[i] for i in fb]),
    ]


def _pooled_results(state, results):
    """(z, u3, beta^n) columns of a pooled stage 1 from its launches'
    results and the bundles' powers."""
    ntv = state["ntv"]
    fb = state["fb"]
    rows = len(ntv)
    h2rho = [state["pool_h2rho"].get(i) for i in range(rows)]
    u3 = [state["pool_u3"].get(i) for i in range(rows)]
    bn = [state["pool_bn"].get(i) for i in range(rows)]
    for j, i in enumerate(fb):
        h2rho[i] = results[1][j]
        bn[i] = results[-1][j]
    if state["joint"]:
        u3_fb = results[2]
    else:
        u3_fb = intops.mod_mul_col(results[2], results[3], [ntv[i] for i in fb])
    for j, i in enumerate(fb):
        u3[i] = u3_fb[j]
    z = intops.mod_mul_col(results[0], h2rho, ntv)
    return z, u3, bn
