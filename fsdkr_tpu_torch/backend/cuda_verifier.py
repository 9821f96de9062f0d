"""Device batch verifier: every proof family of collect() as batched
multi-modulus modexp / modmul columns through the device's arithmetic
families, RNS or CIOS by launch size (the column path of the JAX
package's TpuBatchVerifier).

Equation strategy per family (rewritten to avoid modular inverses
wherever the proof carries the commitment being checked):

- PDL-with-slack (`src/zk_pdl_with_slack.rs:113-168`):
    u2 * c^e  == (1+n)^s1 * s2^n   (mod n^2)
    u3 * z^e  == h1^s1 * h2^s3     (mod N~)
    u1        == s1*G - e*Q        (EC: one combined MSM on the device)
  — no inverses; (1+n)^s1 mod n^2 has the closed form 1 + (s1 mod n)*n.
- Alice range (`src/range_proofs.rs:112-164`): the challenge is recomputed
  from reconstructed u, w, so the actual values are needed:
    w = h1^s1 h2^s2 (z^e)^{-1},  u = (1+s1*n) s^n (c^e)^{-1}
  — z^e, c^e, h1^s1, h2^s2, s^n on the device; the inversions by a
  product tree per modulus group on the device (one host inversion per
  group).
- Ring-Pedersen (`src/ring_pedersen_proof.rs:138-155`): rows (item, i):
    T^{Z_i} == A_i * S^{e_i}  (mod N), e_i in {0,1} — one n*M-row batch.
- Correct-key: sigma_i^N == rho_i (mod N); rho derivation + small-factor
  gates on the host.
- Composite dlog: g^y * ni^e == C (mod N).
- Feldman: one MSM on the device over every scheme's group; host Horner
  per row only for a scheme whose combined check fails.

Three knobs, read at call time and on by default, choose the layout, as
FSDKR_RLC, FSDKR_MULTIEXP and FSDKR_RANGEOPT do in the JAX package:

- FSDKRC_RLC (backend.rlc): PDL, ring-Pedersen and correct-key fold
  their rows into one random-linear-combination check a group (a
  receiver's n PDL rows mod N~ and mod n^2, a proof's M ring-Pedersen
  rows, a proof's correct-key rounds), with fresh 128-bit rho from
  `secrets`: one full-width ladder a group plus short aggregated Straus
  rows (multi_powm), instead of one full-width chain a row. Rows are
  domain-gated before any fold; a failing group bisects on the host
  (backend.rlc.bisect_rows) down to the exact per-row equations, so
  verdicts and blame are the per-row path's. The range family never
  folds: its challenge binds the reconstructed u and w of every row.
  Off, those families check the per-row equations above, in the
  layouts below.

- FSDKRC_MULTIEXP: the mod-n^2 equations as one joint row each,
  u2 ?= gs1 * s2^n * c^{-e} (PDL) and u = gs1 * s^n * c^{-e} (range), on
  the Straus kernel (multi_powm), and the range's w = h1^s1 h2^s2
  (z^{-1})^e: c and z inverted once a row on the host (batch_base_inv),
  so no result is inverted on the device. A c or z with no inverse fails
  just its row, as in the column path.
- FSDKRC_RANGEOPT: the range family on its own engines, as thunks beside
  the PDL columns (utils.pipeline.run_jobs): the u-power of every
  receiver group on the shared-exponent kernel (one segment a group,
  c^{-e} beside it), h1^s1 * h2^s2 by joint_comb2 (the comb), z^{-e} one
  generic column.

The EC checks run on the device EC kernels (ops.ec_batch: one
`ec_scalar_mul` and one `ec_tree_sum` launch per MSM). Hash transcripts
are recomputed on the host.
"""

from __future__ import annotations

import math
import secrets
from functools import partial
from typing import Dict, List

from ..config import ProtocolConfig, DEFAULT_CONFIG
from ..core import intops
from ..core.secp256k1 import N as CURVE_ORDER
from ..core.transcript import challenge_bits
from ..ops import ec_batch
from ..proofs import alice_range, correct_key
from ..proofs.pdl_slack import PDLwSlackProof
from ..proofs.ring_pedersen import RingPedersenProof
from ..ops.limbs import limbs_for_bits
from .batch_verifier import BatchVerifier, HostBatchVerifier
from ..telemetry.spans import get_tracer, phase
from ..utils.roofline import modmul_macs
from ..utils.pipeline import prefetch_tiles, run_jobs
from . import memplan, rlc
from .powm import (
    _cached_ctx,
    batch_base_inv,
    device_modmul,
    device_powm_grouped,
    device_powm_shared_exp_groups,
    fold_ladder2,
    joint_comb2_groups,
    multi_powm,
    multiexp_enabled,
    powm_columns,
    rangeopt_enabled,
)


def batch_inv(values, moduli, device="cuda") -> List:
    """Row-wise modular inverses through the CIOS engine's product tree on
    `device` (ops.montgomery.batch_mod_inv_grouped, the counterpart of
    the JAX package's TpuBatchVerifier._batch_inv): rows group by modulus
    (the collect batch has n rows per receiver modulus), one host
    inversion per group. A group that is not invertible is inverted row
    by row on the host, so the result is None exactly where
    pow(x, -1, m) fails."""
    from ..ops.montgomery import batch_mod_inv_grouped

    if not values:
        return []
    groups: Dict[int, List[int]] = {}
    for i, m in enumerate(moduli):
        groups.setdefault(m, []).append(i)
    glist = [(m, [values[i] for i in idxs]) for m, idxs in groups.items()]
    k = limbs_for_bits(max(m.bit_length() for m in moduli))
    # a product tree: about three Montgomery products a row
    get_tracer().add_macs(modmul_macs(len(values), k))
    ctx = _cached_ctx([m for m, _ in glist], k, device)
    res = batch_mod_inv_grouped(glist, k, device, ctx)
    out: List = [None] * len(values)
    for idxs, invs in zip(groups.values(), res):
        for i, vi in zip(idxs, invs):
            out[i] = vi
    return out


class CudaBatchVerifier(BatchVerifier):
    """Batched verification on the configured torch device, host oracle
    semantics, per-row exact verdicts."""

    def __init__(self, config: ProtocolConfig = DEFAULT_CONFIG):
        self.config = config
        self.device = config.torch_device()
        self._host = HostBatchVerifier(config.hash_alg)
        # one batched multi-modulus modexp: rows sharing a (base, modulus)
        # pair ride the fixed-base comb, the rest the generic engine
        # (backend.powm.device_powm_grouped); powm_columns launches the
        # generic rows of all its width batches together
        self._modexp = partial(device_powm_grouped, device=self.device)

    def _modmul(self, a, b, moduli):
        return device_modmul(a, b, moduli, self.device)

    # ------------------------------------------------------------------
    def _pdl_prepare(self, items, joint: bool = False):
        """Recompute challenges; return (the family's modexp columns,
        carry state for _pdl_finish). Out-of-domain rows
        (PDLwSlackProof.domain_gate) are staged with zeros and
        force-failed in _pdl_finish.

        With joint=True the two mod-n^2 columns collapse into ONE joint
        row per item, u2 ?= gs1 * s2^n * c^{-e}: c^{-1} from the host's
        batched inversion; a row whose c has no inverse is staged dead
        (bases (1, 1), exponents (0, 0)) and checked in _pdl_finish by
        the column form's equality alone."""
        row_ok = [PDLwSlackProof.domain_gate(p, st) for p, st in items]
        with phase("pdl.challenge", items=len(items)):
            e_vec = [
                PDLwSlackProof._challenge(
                    st, p.z, p.u1, p.u2, p.u3, self.config.hash_alg
                )
                if ok
                else 0
                for (p, st), ok in zip(items, row_ok)
            ]
        s1_col = [p.s1 if ok else 0 for (p, _), ok in zip(items, row_ok)]
        s3_col = [p.s3 if ok else 0 for (p, _), ok in zip(items, row_ok)]
        nn_mod = [st.ek.nn for _, st in items]
        nt_mod = [st.N_tilde for _, st in items]
        nt_cols = (
            ([p.z for p, _ in items], e_vec, nt_mod),
            ([st.h1 for _, st in items], s1_col, nt_mod),
            ([st.h2 for _, st in items], s3_col, nt_mod),
        )
        if not joint:
            cols = (
                ([st.ciphertext for _, st in items], e_vec, nn_mod),
                ([p.s2 for p, _ in items], [st.ek.n for _, st in items], nn_mod),
            ) + nt_cols
            return cols, (e_vec, nn_mod, nt_mod, row_ok, None)
        need = [i for i in range(len(items)) if row_ok[i] and e_vec[i] != 0]
        with phase("pdl.base_inv", items=len(need)):
            invs = batch_base_inv([items[i][1].ciphertext for i in need],
                                  [nn_mod[i] for i in need])
        c_inv = [1] * len(items)
        inv_fail = [False] * len(items)
        for i, v in zip(need, invs):
            if v is None:
                inv_fail[i] = True  # the column form's check, in _pdl_finish
            else:
                c_inv[i] = v
        live = [ok and not fail for ok, fail in zip(row_ok, inv_fail)]
        multi = (
            [(p.s2 % st.ek.nn if lv else 1, ci)
             for (p, st), ci, lv in zip(items, c_inv, live)],
            [(st.ek.n if lv else 0, e if lv else 0)
             for (_, st), e, lv in zip(items, e_vec, live)],
            nn_mod,
        )
        return nt_cols + (multi,), (e_vec, nn_mod, nt_mod, row_ok, inv_fail)

    def _pdl_finish(self, items, state, results, session_of=None):
        """Combine the modexp column results into per-row verdicts.
        `session_of` is taken for parity with _pdl_rlc_finish and ignored:
        column verdicts are exact per row."""
        e_vec, nn_mod, nt_mod, row_ok, inv_fail = state
        with phase("pdl.combine", items=len(items)):
            gs1 = [(1 + (p.s1 % st.ek.n) * st.ek.n) % st.ek.nn for p, st in items]
            if inv_fail is None:  # column path
                c_e, s2_n, z_e, h1_s1, h2_s3 = results
                lhs2 = self._modmul([p.u2 for p, _ in items], c_e, nn_mod)
                rhs2 = self._modmul(gs1, s2_n, nn_mod)
                ok2_vec = [lhs2[i] == rhs2[i] and row_ok[i] for i in range(len(items))]
            else:  # joint path: u2 ?= gs1 * s2^n * c^{-e}
                z_e, h1_s1, h2_s3, v2 = results
                rhs2 = self._modmul(gs1, v2, nn_mod)
                ok2_vec = [
                    # gcd(c, n^2) > 1 (adversarial): this row's column form
                    (self._pdl_eq2_exact(items, e_vec, i) if inv_fail[i]
                     else p.u2 % st.ek.nn == rhs2[i]) and row_ok[i]
                    for i, (p, st) in enumerate(items)
                ]
            lhs3 = self._modmul([p.u3 for p, _ in items], z_e, nt_mod)
            rhs3 = self._modmul(h1_s1, h2_s3, nt_mod)
        ok3_vec = [lhs3[i] == rhs3[i] and row_ok[i] for i in range(len(items))]
        return self._pdl_verdicts(items, e_vec, row_ok, ok2_vec, ok3_vec)

    def _pdl_u1_batch(self, items, e_vec) -> List[bool]:
        """u1 == s1*G - e*Q per row (`src/zk_pdl_with_slack.rs:124-127`),
        as ONE combined check on the device:
            sum_j rho_j*u1_j + sum_j (rho_j e_j)*Q_j + (-sum_j rho_j s1_j)*G
            == identity
        with secret 128-bit rho_j: one `batch_msm` of 2 * rows + 1 points.
        The rows are checked one by one on the host only where the
        combined check fails or the rows' G differ (the JAX package's
        TpuBatchVerifier._pdl_u1_batch, its blame semantics)."""
        if not items:
            return []
        g = items[0][1].G
        if any(st.G != g for _, st in items):
            return self._pdl_u1_host(items, e_vec)
        rho = [secrets.randbits(128) for _ in items]
        points = [p.u1 for p, _ in items] + [st.Q for _, st in items] + [g]
        s_combined = sum(
            r * (p.s1 % CURVE_ORDER) for r, (p, _) in zip(rho, items)
        ) % CURVE_ORDER
        scalars = (
            rho
            + [r * e % CURVE_ORDER for r, e in zip(rho, e_vec)]
            + [CURVE_ORDER - s_combined]
        )
        (combined,) = ec_batch.batch_msm([points], [scalars], device=self.device)
        if combined.infinity:
            return [True] * len(items)
        return self._pdl_u1_host(items, e_vec)

    @staticmethod
    def _pdl_u1_host(items, e_vec) -> List[bool]:
        """u1 == s1*G - e*Q per row (`src/zk_pdl_with_slack.rs:124-127`),
        as one native launch of u1 ?= s1*G + (q - e)*Q (native/ec.py)."""
        from ..native import ec as native_ec

        evals = native_ec.lincomb2_batch(
            [None if st.G.infinity else (st.G.x, st.G.y) for _, st in items],
            [p.s1 % CURVE_ORDER for p, _ in items],
            [None if st.Q.infinity else (st.Q.x, st.Q.y) for _, st in items],
            [(CURVE_ORDER - e % CURVE_ORDER) % CURVE_ORDER for e in e_vec],
        )
        return [
            p.u1.infinity if ev is None
            else (not p.u1.infinity) and p.u1.x == ev[0] and p.u1.y == ev[1]
            for (p, _), ev in zip(items, evals)
        ]

    # -- FSDKRC_RLC: the PDL rows folded a receiver at a time -----------
    def _pdl_rlc_prepare(self, items):
        """Gate rows, recompute challenges, and fold the live rows into
        one mod-N~ and one mod-n^2 RLC group a receiver (the rows
        addressed to one receiver share its (h1, h2, N~) and Paillier
        key). Returns (cols, state): cols is ONE joint column holding
        every group's phase-1 rows (eq3's aggregate prod u3^rho z^(rho e);
        eq2's s2-aggregate and its u2/c aggregate), which powm_columns
        pools with any co-launched joint column. Each mod-N~ group's
        merged h1/h2 row goes to fold_ladder2 in _pdl_rlc_finish, and so
        does phase 2, each s2-aggregate raised to n. An out-of-domain row
        enters no fold and is force-failed in finish."""
        row_ok = [PDLwSlackProof.domain_gate(p, st) for p, st in items]
        with phase("pdl.challenge", items=len(items)):
            e_vec = [
                PDLwSlackProof._challenge(st, p.z, p.u1, p.u2, p.u3, self.config.hash_alg)
                if ok
                else 0
                for (p, st), ok in zip(items, row_ok)
            ]
        col, nt_fold, nn_fold = self._pdl_fold_span(items, e_vec, row_ok, range(len(items)))
        groups = len(nt_fold) + len(nn_fold)
        rlc.count("rlc_groups", groups)
        # eq3's merged h1/h2 ladder and eq2's phase-2 power: one full-width
        # chain a group
        rlc.count("fullwidth_ladders", groups)
        return (col,), (e_vec, row_ok, nt_fold, nn_fold)

    def _pdl_fold_span(self, items, e_vec, row_ok, span):
        """Fold the live rows of `span` (indices into items) into one
        mod-N~ and one mod-n^2 RLC group a receiver, each with fresh rhos.
        Returns ((mb, me, mm), nt_fold, nn_fold): the joint column of the
        groups' aggregated short chains; nt_fold holds (key (h1, h2, N~),
        rows, merged (h1, h2) exponents, position of the chain) a group,
        nn_fold (key (n, n^2), rows, merged (1+n) exponent mod n, position
        of the s2-aggregate, the u2/c aggregate after it) a group."""
        nt_groups: Dict[tuple, List[int]] = {}
        nn_groups: Dict[tuple, List[int]] = {}
        for i in span:
            if row_ok[i]:
                st = items[i][1]
                nt_groups.setdefault((st.h1, st.h2, st.N_tilde), []).append(i)
                nn_groups.setdefault((st.ek.n, st.ek.nn), []).append(i)
        mb, me, mm = [], [], []
        nt_fold = []
        for (h1, h2, nt), idxs in nt_groups.items():
            lhs, rhs = PDLwSlackProof.rlc_fold_nt(
                h1, h2, nt, self._pdl_nt_rows(items, e_vec, idxs), rlc.sample_rhos(len(idxs)))
            nt_fold.append(((h1, h2, nt), idxs, lhs[1], len(mm)))
            mb.append(rhs[0])
            me.append(rhs[1])
            mm.append(rhs[2])
        nn_fold = []
        for (n, nn), idxs in nn_groups.items():
            s2_row, commit_row, gs1 = PDLwSlackProof.rlc_fold_nn(
                n, nn, self._pdl_nn_rows(items, e_vec, idxs), rlc.sample_rhos(len(idxs)))
            # gs1 = 1 + (sum rho s1 mod n) n: keep the exponent
            nn_fold.append(((n, nn), idxs, (gs1 - 1) // n, len(mm)))
            for b, e, m in (s2_row, commit_row):
                mb.append(b)
                me.append(e)
                mm.append(m)
        rlc.count("rows_folded", sum(map(len, nt_groups.values()))
                  + sum(map(len, nn_groups.values())))
        return (mb, me, mm), nt_fold, nn_fold

    @staticmethod
    def _pdl_nt_rows(items, e_vec, idxs):
        """rlc_fold_nt's row layout: (z, u3, e, s1, s3) a row."""
        return [(items[i][0].z, items[i][0].u3, e_vec[i], items[i][0].s1, items[i][0].s3)
                for i in idxs]

    @staticmethod
    def _pdl_nn_rows(items, e_vec, idxs):
        """rlc_fold_nn's row layout: (u2, c, e, s1, s2) a row."""
        return [(items[i][0].u2, items[i][1].ciphertext, e_vec[i], items[i][0].s1,
                 items[i][0].s2)
                for i in idxs]

    @staticmethod
    def _pdl_eq3_exact(items, e_vec, i) -> bool:
        """The column form's mod-N~ equality for exactly row i (a
        bisection leaf)."""
        p, st = items[i]
        nt = st.N_tilde
        lhs = p.u3 % nt * intops.mod_pow(p.z % nt, e_vec[i], nt) % nt
        rhs = intops.mod_pow(st.h1 % nt, p.s1, nt) * intops.mod_pow(st.h2 % nt, p.s3, nt) % nt
        return lhs == rhs

    @staticmethod
    def _pdl_eq2_exact(items, e_vec, i) -> bool:
        """The column form's mod-n^2 equality for exactly row i."""
        p, st = items[i]
        n, nn = st.ek.n, st.ek.nn
        lhs = p.u2 % nn * intops.mod_pow(st.ciphertext % nn, e_vec[i], nn) % nn
        gs1 = (1 + (p.s1 % n) * n) % nn
        return lhs == gs1 * intops.mod_pow(p.s2 % nn, n, nn) % nn

    def _pdl_nt_subset_check(self, items, e_vec, h1, h2, nt, sub) -> bool:
        """A fresh-rho combined mod-N~ check over a row subset (a
        bisection node), on the host: bisection is the rare adversarial
        path, run only inside a group whose combined check failed."""
        rho = rlc.sample_rhos(len(sub))
        lhs, rhs = PDLwSlackProof.rlc_fold_nt(h1, h2, nt, self._pdl_nt_rows(items, e_vec, sub),
                                              rho)
        va, vb = multi_powm([lhs[0], rhs[0]], [lhs[1], rhs[1]], [nt, nt], device=None)
        return va == vb

    def _pdl_nn_subset_check(self, items, e_vec, n, nn, sub) -> bool:
        """A fresh-rho combined mod-n^2 check over a row subset, on the
        host."""
        rho = rlc.sample_rhos(len(sub))
        s2_row, commit_row, gs1 = PDLwSlackProof.rlc_fold_nn(
            n, nn, self._pdl_nn_rows(items, e_vec, sub), rho)
        av, cv = multi_powm([s2_row[0], commit_row[0]], [s2_row[1], commit_row[1]], [nn, nn],
                            device=None)
        return cv == gs1 * intops.mod_pow(av, n, nn) % nn

    def _pdl_nt_bisect(self, items, e_vec, h1, h2, nt, idxs, ok3_vec, session_of=None):
        """Per-row mod-N~ verdicts of a failing group into ok3_vec: its
        rows bisected (session-first where `session_of` is given: rows
        merged across fused sessions) down to the exact per-row check."""
        rlc.count("bisect_fallbacks")
        combined = partial(self._pdl_nt_subset_check, items, e_vec, h1, h2, nt)
        exact = partial(self._pdl_eq3_exact, items, e_vec)
        verdicts = (rlc.bisect_sessions(idxs, session_of, combined, exact)
                    if session_of is not None else rlc.bisect_rows(idxs, combined, exact))
        for i, v in verdicts.items():
            ok3_vec[i] = v

    def _pdl_nn_bisect(self, items, e_vec, n, nn, idxs, ok2_vec, session_of=None):
        """The mod-n^2 counterpart of _pdl_nt_bisect, into ok2_vec."""
        rlc.count("bisect_fallbacks")
        combined = partial(self._pdl_nn_subset_check, items, e_vec, n, nn)
        exact = partial(self._pdl_eq2_exact, items, e_vec)
        verdicts = (rlc.bisect_sessions(idxs, session_of, combined, exact)
                    if session_of is not None else rlc.bisect_rows(idxs, combined, exact))
        for i, v in verdicts.items():
            ok2_vec[i] = v

    def _pdl_verdicts(self, items, e_vec, row_ok, ok2_vec, ok3_vec, ok1_vec=None):
        """The (u1, u2, u3) triples of _pdl_finish from the per-equation
        vectors; the EC u1 column as one device MSM unless given (the
        streamed path's tiles computed it)."""
        if ok1_vec is None:
            with phase("pdl.ec_u1", items=len(items)):
                ok1_vec = self._pdl_u1_batch(items, e_vec)
        out = []
        for idx in range(len(items)):
            ok1 = ok1_vec[idx] and row_ok[idx]
            ok2, ok3 = ok2_vec[idx], ok3_vec[idx]
            out.append(None if (ok1 and ok2 and ok3) else (ok1, ok2, ok3))
        return out

    def _pdl_rlc_finish(self, items, state, results, session_of=None):
        """Compare each group's folded equation, bisect the failing groups
        down to exact per-row verdicts (session-first where `session_of`
        maps a row to its session in a fused multi-session batch), and
        give the same (u1, u2, u3) triples as _pdl_finish."""
        e_vec, row_ok, nt_fold, nn_fold = state
        (multi_res,) = results
        ok2_vec, ok3_vec = self._pdl_rlc_compare(
            items, e_vec,
            [(key, idxs, exps, multi_res[pos]) for key, idxs, exps, pos in nt_fold],
            [(key, idxs, s1_sum, multi_res[pos], multi_res[pos + 1])
             for key, idxs, s1_sum, pos in nn_fold],
            session_of)
        return self._pdl_verdicts(items, e_vec, row_ok, ok2_vec, ok3_vec)

    def _pdl_rlc_compare(self, items, e_vec, nt_groups, nn_groups, session_of):
        """(ok2_vec, ok3_vec) of folded groups, for the monolithic and the
        streamed fold alike. nt_groups: (key (h1, h2, N~), rows, merged
        (h1, h2) exponents, the aggregated chain's value) a group;
        nn_groups: (key (n, n^2), rows, merged (1+n) exponent, the
        s2-aggregate, the u2/c aggregate) a group. On the device: every
        mod-N~ group's merged h1/h2 row in one fold_ladder2 call, every
        s2-aggregate to the n in one generic launch (phase 2, the group's
        one remaining full-width chain). A failing group bisects down to
        exact per-row checks."""
        ok2_vec = [False] * len(items)
        ok3_vec = [False] * len(items)
        with phase("pdl.rlc_eq3", items=sum(len(g[1]) for g in nt_groups)):
            lhs_vals = fold_ladder2([((h1, h2), tuple(exps), nt)
                                     for (h1, h2, nt), _, exps, _ in nt_groups], self.device)
            for ((h1, h2, nt), idxs, _, rhs), lhs in zip(nt_groups, lhs_vals):
                if lhs == rhs:
                    for i in idxs:
                        ok3_vec[i] = True
                else:
                    self._pdl_nt_bisect(items, e_vec, h1, h2, nt, idxs, ok3_vec, session_of)
        with phase("pdl.rlc_eq2", items=sum(len(g[1]) for g in nn_groups)):
            a_pow = self._modexp([g[3] for g in nn_groups], [g[0][0] for g in nn_groups],
                                 [g[0][1] for g in nn_groups])
            for ((n, nn), idxs, s1_sum, _, commit), ap in zip(nn_groups, a_pow):
                if commit == (1 + (s1_sum % n) * n) % nn * ap % nn:
                    for i in idxs:
                        ok2_vec[i] = True
                else:
                    self._pdl_nn_bisect(items, e_vec, n, nn, idxs, ok2_vec, session_of)
        return ok2_vec, ok3_vec

    def _pdl_layout(self, items):
        """(cols, state, finish) of the PDL family under the knobs: the RLC
        fold, else the joint or column layout."""
        if rlc.rlc_enabled():
            cols, state = self._pdl_rlc_prepare(items)
            return cols, state, self._pdl_rlc_finish
        cols, state = self._pdl_prepare(items, joint=multiexp_enabled())
        return cols, state, self._pdl_finish

    def verify_pdl(self, items):
        if not items:
            return []
        cols, state, finish = self._pdl_layout(items)
        with phase("pdl.modexp_columns", items=len(cols) * len(items)):
            results = powm_columns(self._modexp, *cols)
        return finish(items, state, results)

    # ------------------------------------------------------------------
    def _range_gate(self, items):
        """Domain-gate every row (AliceProof.domain_gate, including the
        q^3 slack bound on s1) and zero the challenge of gated rows. One
        implementation for every layout, so all gate alike."""
        nn_mod = [ek.nn for _, _, ek, _ in items]
        nt_mod = [dlog.N for _, _, _, dlog in items]
        row_ok = [
            alice_range.AliceProof.domain_gate(p, c, dlog)
            for p, c, _, dlog in items
        ]
        e_vec = [
            p.e if ok else 0 for (p, _, _, _), ok in zip(items, row_ok)
        ]
        return nn_mod, nt_mod, row_ok, e_vec

    def _range_base_inv(self, items, nn_mod, nt_mod, row_ok, e_vec):
        """The range family's batched base inversions (z mod N~, c mod
        n^2) of the live e != 0 rows; an e == 0 row never inverts (x^0 = 1,
        as on the host). Returns (z_inv, c_inv, inv_fail): a z or c with no
        inverse marks only its own row, which the caller fails as the host
        verifier does. One implementation for the joint and RANGEOPT
        layouts."""
        rows = len(items)
        need = [i for i in range(rows) if row_ok[i] and e_vec[i] != 0]
        with phase("range.base_inv", items=2 * len(need)):
            z_invs = batch_base_inv([items[i][0].z for i in need], [nt_mod[i] for i in need])
            c_invs = batch_base_inv([items[i][1] for i in need], [nn_mod[i] for i in need])
        z_inv = [1] * rows
        c_inv = [1] * rows
        inv_fail = [False] * rows
        for i, zv, cv in zip(need, z_invs, c_invs):
            if zv is None or cv is None:
                inv_fail[i] = True
            else:
                z_inv[i], c_inv[i] = zv, cv
        return z_inv, c_inv, inv_fail

    def _range_prepare(self, items, joint: bool = False):
        """Return (the family's modexp columns, carry state for
        _range_finish). Column order matches _range_finish.

        With joint=True the verifier computes the reference's own
        equation shapes: w = h1^s1 h2^s2 (z^{-1})^e and u = gs1 * s^n *
        c^{-e}, the bases inverted once a row on the host, the mod-n^2
        pair one joint 2-term row; no result inversion on the device."""
        nn_mod, nt_mod, row_ok, e_vec = self._range_gate(items)
        s1_col = [
            p.s1 if ok else 0 for (p, _, _, _), ok in zip(items, row_ok)
        ]
        s2_col = [
            p.s2 if ok else 0 for (p, _, _, _), ok in zip(items, row_ok)
        ]
        comb_cols = (
            ([dlog.g for _, _, _, dlog in items], s1_col, nt_mod),
            ([dlog.ni for _, _, _, dlog in items], s2_col, nt_mod),
        )
        if not joint:
            cols = (
                ([p.z for p, _, _, _ in items], e_vec, nt_mod),
            ) + comb_cols + (
                ([c for _, c, _, _ in items], e_vec, nn_mod),
                (
                    [p.s for p, _, _, _ in items],
                    [ek.n for _, _, ek, _ in items],
                    nn_mod,
                ),
            )
            return cols, (nn_mod, nt_mod, row_ok, None)
        z_inv, c_inv, inv_fail = self._range_base_inv(items, nn_mod, nt_mod, row_ok, e_vec)
        live = [ok and not fail for ok, fail in zip(row_ok, inv_fail)]
        e_live = [e if lv else 0 for e, lv in zip(e_vec, live)]
        multi = (
            [(p.s % ek.nn if lv else 1, ci)
             for (p, _, ek, _), ci, lv in zip(items, c_inv, live)],
            [(ek.n if lv else 0, e) for (_, _, ek, _), e, lv in zip(items, e_live, live)],
            nn_mod,
        )
        return ((z_inv, e_live, nt_mod),) + comb_cols + (multi,), (
            nn_mod, nt_mod, row_ok, inv_fail)

    def _range_finish(self, items, mods, results):
        nn_mod, nt_mod, row_ok, inv_fail = mods
        with phase("range.combine", items=len(items)):
            w_part = self._modmul(results[1], results[2], nt_mod)  # h1^s1 * h2^s2
            # domain-gated rows are force-failed below and skipped here: an
            # adversarial s1 on a gated row can be arbitrarily wide
            gs1 = [
                (1 + p.s1 * ek.n) % ek.nn if ok else 1
                for (p, _, ek, _), ok in zip(items, row_ok)
            ]
            if inv_fail is None:  # column path
                z_e, _, _, c_e, s_n = results
                u_part = self._modmul(gs1, s_n, nn_mod)
            else:
                z_inv_e, _, _, v_u = results
                w_vec = self._modmul(w_part, z_inv_e, nt_mod)
                u_vec = self._modmul(gs1, v_u, nn_mod)
        if inv_fail is None:
            with phase("range.batch_inv", items=2 * len(items)):
                z_e_inv_vec = batch_inv(z_e, nt_mod, self.device)
                c_e_inv_vec = batch_inv(c_e, nn_mod, self.device)
        out = []
        with phase("range.challenge", items=len(items)):
            for idx, (proof, cipher, ek, dlog) in enumerate(items):
                if not row_ok[idx]:
                    out.append(False)
                    continue
                if inv_fail is None:
                    z_e_inv = z_e_inv_vec[idx]
                    c_e_inv = c_e_inv_vec[idx]
                    if z_e_inv is None or c_e_inv is None:
                        out.append(False)
                        continue
                    w = w_part[idx] * z_e_inv % dlog.N
                    u = u_part[idx] * c_e_inv % ek.nn
                else:
                    if inv_fail[idx]:
                        out.append(False)
                        continue
                    w, u = w_vec[idx], u_vec[idx]
                out.append(
                    alice_range._challenge(
                        ek.n, cipher, proof.z, u, w, self.config.hash_alg
                    )
                    == proof.e
                )
        return out

    # -- FSDKRC_RANGEOPT: the range family's own engines ---------------
    def _range_opt_prepare(self, items):
        """Gate rows, invert the bases, and group the live rows by
        receiver: (n, n^2) for the u-power (every row of a receiver
        raises its s to the receiver's public n), (h1, h2, N~) for the
        w-part. A gated or non-invertible row enters no group."""
        rows = len(items)
        nn_mod, nt_mod, row_ok, e_vec = self._range_gate(items)
        z_inv, c_inv, inv_fail = self._range_base_inv(items, nn_mod, nt_mod, row_ok, e_vec)
        live = [ok and not fail for ok, fail in zip(row_ok, inv_fail)]
        nn_groups: Dict[tuple, List[int]] = {}
        nt_groups: Dict[tuple, List[int]] = {}
        for i in range(rows):
            if not live[i]:
                continue
            _, _, ek, dlog = items[i]
            nn_groups.setdefault((ek.n, ek.nn), []).append(i)
            nt_groups.setdefault((dlog.g, dlog.ni, dlog.N), []).append(i)
        return dict(
            nn_mod=nn_mod, nt_mod=nt_mod, row_ok=row_ok, e_vec=e_vec,
            z_inv=z_inv, c_inv=c_inv, live=live,
            nn_groups=nn_groups, nt_groups=nt_groups,
            u_pow=[1] * rows, hs=[1] * rows, z_pow=[1] * rows,
        )

    def _range_opt_jobs(self, items, state):
        """The range family's launch sets as thunks for run_jobs: every
        receiver group's u-power s^n * c^{-e} mod n^2 in one
        device_powm_shared_exp_groups call (one shared-exponent launch,
        one generic launch for the c^{-e} terms, one modmul), every
        receiver environment's h1^s1 * h2^s2 mod N~ in one
        joint_comb2_groups call, and the z^{-e} column. Each thunk writes
        only its own rows of the state."""
        e_vec, c_inv, z_inv = state["e_vec"], state["c_inv"], state["z_inv"]
        jobs = []
        nn_groups = list(state["nn_groups"].items())
        nt_groups = list(state["nt_groups"].items())
        if nn_groups:
            def u_job():
                with phase("range.u_pow", items=sum(len(idxs) for _, idxs in nn_groups)):
                    res = device_powm_shared_exp_groups(
                        [([items[i][0].s for i in idxs], n, nn, [c_inv[i] for i in idxs],
                          [e_vec[i] for i in idxs]) for (n, nn), idxs in nn_groups],
                        self.device)
                for (_, idxs), vals in zip(nn_groups, res):
                    for i, v in zip(idxs, vals):
                        state["u_pow"][i] = v

            jobs.append(u_job)
        if nt_groups:
            def w_job():
                with phase("range.comb2", items=sum(len(idxs) for _, idxs in nt_groups)):
                    res = joint_comb2_groups(
                        [(h1, [items[i][0].s1 for i in idxs], h2,
                          [items[i][0].s2 for i in idxs], nt)
                         for (h1, h2, nt), idxs in nt_groups],
                        self.device)
                for (_, idxs), vals in zip(nt_groups, res):
                    for i, v in zip(idxs, vals):
                        state["hs"][i] = v

            jobs.append(w_job)
        z_rows = [i for i in range(len(items)) if state["live"][i] and e_vec[i]]
        if z_rows:
            def z_job():
                with phase("range.z_e", items=len(z_rows)):
                    res = self._modexp([z_inv[i] for i in z_rows], [e_vec[i] for i in z_rows],
                                       [state["nt_mod"][i] for i in z_rows])
                for i, v in zip(z_rows, res):
                    state["z_pow"][i] = v

            jobs.append(z_job)
        return jobs

    def _range_opt_finish(self, items, state):
        """u = gs1 * u_pow mod n^2, w = hs * z_pow mod N~, then the
        challenge of every live row."""
        idxs = [i for i in range(len(items)) if state["live"][i]]
        with phase("range.combine", items=len(idxs)):
            # gs1 only for live rows: s1 <= q^3 by the domain gate
            gs1 = [(1 + items[i][0].s1 * items[i][2].n) % items[i][2].nn for i in idxs]
            u_col = self._modmul(gs1, [state["u_pow"][i] for i in idxs],
                                 [state["nn_mod"][i] for i in idxs])
            w_col = self._modmul([state["hs"][i] for i in idxs],
                                 [state["z_pow"][i] for i in idxs],
                                 [state["nt_mod"][i] for i in idxs])
        out = [False] * len(items)
        with phase("range.challenge", items=len(idxs)):
            for i, u, w in zip(idxs, u_col, w_col):
                proof, cipher, ek, _ = items[i]
                out[i] = alice_range._challenge(
                    ek.n, cipher, proof.z, u, w, self.config.hash_alg
                ) == proof.e
        return out

    def verify_range(self, items):
        if not items:
            return []
        if rangeopt_enabled():
            state = self._range_opt_prepare(items)
            run_jobs(self._range_opt_jobs(items, state))
            return self._range_opt_finish(items, state)
        cols, mods = self._range_prepare(items, joint=multiexp_enabled())
        with phase("range.modexp_columns", items=len(cols) * len(items)):
            results = powm_columns(self._modexp, *cols)
        return self._range_finish(items, mods, results)

    # ------------------------------------------------------------------
    def verify_pairs(self, pdl_items, range_items, session_spans=None):
        """Both pair-loop families of a collect (the JAX package's
        TpuBatchVerifier.verify_pairs dispatch):

        - a fused multi-session batch (`session_spans`: session -> [lo, hi)
          row span, from `RefreshMessage.collect_sessions`) first runs the
          cross-session value dedup: one representative of each distinct
          row verified, its verdict fanned out; distinct rows keep their
          sessions, and a failing RLC group merged across sessions bisects
          session-first;
        - a batch whose estimated staged bytes exceed the memory plan's
          budget (`memplan.mem_budget_bytes`) runs tile by tile
          (`_verify_pairs_streamed`);
        - the rest take one fused launch set (`_verify_pairs_monolithic`).

        Verdicts and blame are the same on every path."""
        if not pdl_items or not range_items:
            return self.verify_pdl(pdl_items), self.verify_range(range_items)
        same_rows = len(pdl_items) == len(range_items)
        if session_spans is not None and len(session_spans) > 1 and same_rows:
            ded = self._xsession_dedup(pdl_items, range_items)
            if ded is not None:
                return ded
        session_of = self._session_of(session_spans, len(pdl_items))
        if same_rows:
            # the streamed path cuts both families on one row axis
            plan = self._pair_plan(pdl_items, self.device)
            if plan is not None and plan.multi_tile:
                return self._verify_pairs_streamed(pdl_items, range_items, plan, session_of)
        return self._verify_pairs_monolithic(pdl_items, range_items, session_of)

    @staticmethod
    def _session_of(session_spans, n_rows):
        """Row index -> owning session, or None when the batch holds one
        session at most."""
        if not session_spans or len(session_spans) <= 1:
            return None
        owner = [0] * n_rows
        for s, (lo, hi) in session_spans.items():
            owner[lo:hi] = [s] * (hi - lo)
        return owner.__getitem__

    def _xsession_dedup(self, pdl_items, range_items):
        """Verify one representative of each distinct (PDL row, range
        row) value and fan its verdicts out to the rows equal to it. Every
        component of a row (the proofs, PDLwSlackStatement, EncryptionKey,
        DLogStatement, Point) is a frozen value type, so the row pair is
        its own key and covers every input its verdict depends on; a row
        is marked invalid only through its exact check, so the fan-out is
        exact. None when no two rows are equal (distinct committees): the
        caller then verifies the fused batch with session-first blame."""
        first: Dict[tuple, int] = {}
        rep_idx: List[int] = []
        owners: List[List[int]] = []
        for i, row in enumerate(zip(pdl_items, range_items)):
            j = first.get(row)
            if j is None:
                first[row] = len(rep_idx)
                rep_idx.append(i)
                owners.append([i])
            else:
                owners[j].append(i)
        if len(rep_idx) == len(pdl_items):
            return None
        rlc.count("xsession_rows_deduped", len(pdl_items) - len(rep_idx))
        with phase("pairs.xsession_dedup", items=len(pdl_items), unique=len(rep_idx)):
            p_u, r_u = self.verify_pairs([pdl_items[i] for i in rep_idx],
                                         [range_items[i] for i in rep_idx])
        pdl_out = [None] * len(pdl_items)
        range_out = [False] * len(range_items)
        for j, rows in enumerate(owners):
            for i in rows:
                pdl_out[i] = p_u[j]
                range_out[i] = r_u[j]
        return pdl_out, range_out

    @staticmethod
    def _pair_plan(pdl_items, device):
        """The tile plan of a pair batch. Its widths are the receiver's own
        key vectors' (ek.nn, N~): public and verifier-local, so wire fields
        cannot shape the cut."""
        nn_bits = max(st.ek.nn.bit_length() for _, st in pdl_items)
        nt_bits = max(st.N_tilde.bit_length() for _, st in pdl_items)
        return memplan.plan_rows(len(pdl_items), memplan.pair_row_bytes(nn_bits, nt_bits),
                                 label="pairs", device=device)

    def _verify_pairs_streamed(self, pdl_items, range_items, plan, session_of=None):
        """The pair batch tile by tile under the memory plan: each tile is
        staged, verified and released before the next is admitted, and the
        next tile's host staging (domain gates, Fiat-Shamir challenges)
        runs behind the current tile's launches (prefetch_tiles).

        Row-local work (the range family, the EC u1 column, the whole
        FSDKRC_RLC=0 path) completes inside its tile. The PDL RLC folds
        accumulate a running partial product a group (rlc.StreamFold): a
        tile adds its short aggregated chains (one multi_powm) and its
        merged-exponent sums, and each group's full-width ladders run once
        at finish, so `fullwidth_ladders` is the monolithic plan's. A
        failing group bisects through the monolithic path's helpers."""
        rows = len(pdl_items)
        range_out = [False] * rows

        if not rlc.rlc_enabled():
            pdl_out = [None] * rows

            def consume_cols(span):
                lo, hi = span
                nbytes = plan.tile_bytes(hi - lo)
                memplan.stage(nbytes)
                try:
                    memplan.count_tile("pairs")
                    rlc.count("stream_tiles")
                    pdl_out[lo:hi], range_out[lo:hi] = self._verify_pairs_monolithic(
                        pdl_items[lo:hi], range_items[lo:hi])
                finally:
                    memplan.release(nbytes)

            with phase("pairs.stream_tiles", items=rows, tiles=len(plan.tiles)):
                prefetch_tiles(plan.tiles, lambda lo, hi: (lo, hi), consume_cols)
            return pdl_out, range_out

        e_vec = [0] * rows
        row_ok = [False] * rows
        ok1_vec = [False] * rows
        nt_folds: Dict[tuple, rlc.StreamFold] = {}
        nn_folds: Dict[tuple, rlc.StreamFold] = {}

        def prepare(lo, hi):
            # host-only staging of the next tile, read-only over shared state
            tile = pdl_items[lo:hi]
            p_ok = [PDLwSlackProof.domain_gate(p, st) for p, st in tile]
            with phase("pdl.challenge", items=len(tile)):
                e_tile = [
                    PDLwSlackProof._challenge(st, p.z, p.u1, p.u2, p.u3, self.config.hash_alg)
                    if ok else 0
                    for (p, st), ok in zip(tile, p_ok)
                ]
            return lo, hi, p_ok, e_tile

        def consume(prep):
            lo, hi, p_ok, e_tile = prep
            row_ok[lo:hi] = p_ok
            e_vec[lo:hi] = e_tile
            nbytes = plan.tile_bytes(hi - lo)
            memplan.stage(nbytes)
            try:
                memplan.count_tile("pairs")
                rlc.count("stream_tiles")
                (mb, me, mm), nt_fold, nn_fold = self._pdl_fold_span(
                    pdl_items, e_vec, row_ok, range(lo, hi))
                with phase("pdl.rlc_fold", items=len(mm)):
                    res = multi_powm(mb, me, mm, self.device) if mm else []
                for key, idxs, exps, pos in nt_fold:
                    fold = nt_folds.get(key)
                    if fold is None:
                        fold = nt_folds[key] = rlc.StreamFold(key[2], n_prods=1, n_exps=2)
                    fold.absorb([res[pos]], exps, idxs)
                for key, idxs, s1_sum, pos in nn_fold:
                    fold = nn_folds.get(key)
                    if fold is None:
                        fold = nn_folds[key] = rlc.StreamFold(key[1], n_prods=2, n_exps=1)
                    fold.absorb([res[pos], res[pos + 1]], (s1_sum,), idxs)
                range_out[lo:hi] = self.verify_range(range_items[lo:hi])
                with phase("pdl.ec_u1", items=hi - lo):
                    ok1_vec[lo:hi] = self._pdl_u1_batch(pdl_items[lo:hi], e_tile)
            finally:
                memplan.release(nbytes)

        with phase("pairs.stream_tiles", items=rows, tiles=len(plan.tiles)):
            prefetch_tiles(plan.tiles, prepare, consume)

        # finish: each group's full-width ladders, once
        groups = len(nt_folds) + len(nn_folds)
        rlc.count("rlc_groups", groups)
        rlc.count("fullwidth_ladders", groups)
        ok2_vec, ok3_vec = self._pdl_rlc_compare(
            pdl_items, e_vec,
            [(key, f.rows, f.exp_sums, f.prods[0]) for key, f in nt_folds.items()],
            [(key, f.rows, f.exp_sums[0], f.prods[0], f.prods[1]) for key, f in nn_folds.items()],
            session_of)
        return self._pdl_verdicts(pdl_items, e_vec, row_ok, ok2_vec, ok3_vec, ok1_vec), range_out

    def _verify_pairs_monolithic(self, pdl_items, range_items, session_of=None):
        """Both pair-loop families through ONE fused launch set: every
        modexp column submitted together, so same-width columns across
        families share launches, and under FSDKRC_MULTIEXP both families'
        joint mod-n^2 rows share one Straus launch. Under FSDKRC_RLC the
        PDL family's column is its RLC fold's joint column (the range
        family never folds). Under FSDKRC_RANGEOPT the range family's
        engines run as thunks after the PDL columns; without it, the PDL
        columns pool with the range columns in one powm_columns call."""
        pcols, state, pdl_finish = self._pdl_layout(pdl_items)
        if rangeopt_enabled():
            rstate = self._range_opt_prepare(range_items)
            presults = [None]

            def pdl_job():
                with phase("pdl.modexp_columns", items=len(pcols) * len(pdl_items)):
                    presults[0] = powm_columns(self._modexp, *pcols)

            jobs = [pdl_job] + self._range_opt_jobs(range_items, rstate)
            with phase("pairs.modexp_columns",
                       items=len(pcols) * len(pdl_items) + len(range_items)):
                run_jobs(jobs)
            return (
                pdl_finish(pdl_items, state, presults[0], session_of=session_of),
                self._range_opt_finish(range_items, rstate),
            )
        rcols, rmods = self._range_prepare(range_items, joint=multiexp_enabled())
        with phase("pairs.modexp_columns",
                   items=len(pcols) * len(pdl_items) + len(rcols) * len(range_items)):
            results = powm_columns(self._modexp, *pcols, *rcols)
        return (
            pdl_finish(pdl_items, state, results[: len(pcols)], session_of=session_of),
            self._range_finish(range_items, rmods, results[len(pcols) :]),
        )

    # ------------------------------------------------------------------
    def _ring_pedersen_gate(self, proof, st, m_security) -> bool:
        """The statement modulus and the proof vectors are wire data: gate
        the row before staging (honest: A_i < N, Z_i < phi < N)."""
        n_cap = self.config.paillier_bits + 64
        return (
            len(proof.A) == m_security
            and len(proof.Z) == m_security
            and st.N > 2
            and st.N % 2 == 1
            and st.N.bit_length() <= n_cap
            and 0 <= st.S < st.N
            and 0 <= st.T < st.N
            and all(0 <= z < st.N for z in proof.Z)
            and all(0 <= a < st.N for a in proof.A)
        )

    def verify_ring_pedersen(self, items, m_security):
        if not items:
            return []
        if rlc.rlc_enabled():
            return self._ring_pedersen_rlc(items, m_security)
        bases, exps, moduli, rhs_a, rhs_s = [], [], [], [], []
        shapes_ok = []
        with phase("ringped.challenge", items=len(items)):
            for proof, st in items:
                ok = self._ring_pedersen_gate(proof, st, m_security)
                shapes_ok.append(ok)
                if not ok:
                    continue
                e = RingPedersenProof._challenge(proof.A, self.config.hash_alg)
                bits = challenge_bits(e, m_security, self.config.hash_alg)
                for a_i, z_i, b in zip(proof.A, proof.Z, bits):
                    bases.append(st.T)
                    exps.append(z_i)
                    moduli.append(st.N)
                    rhs_a.append(a_i)
                    rhs_s.append(st.S if b else 1)

        with phase("ringped.modexp", items=len(bases)):
            lhs = self._modexp(bases, exps, moduli)
            rhs = self._modmul(rhs_a, rhs_s, moduli)

        out = []
        row = 0
        for ok in shapes_ok:
            if not ok:
                out.append(False)
                continue
            good = all(
                lhs[row + i] == rhs[row + i] for i in range(m_security)
            )
            row += m_security
            out.append(good)
        return out

    def _ring_pedersen_rlc(self, items, m_security):
        """FSDKRC_RLC: each proof's M rows, all sharing (T, S, N), fold into
        one RLC group (RingPedersenProof.rlc_fold): one full-width T-ladder
        (a flat column, T^(sum rho Z)) and one joint row of M + 1 short
        terms (prod A^rho * S^(sum rho e)), both columns in one
        powm_columns call, instead of M full-width comb rows. A failing
        group bisects on the host down to the exact per-row equations."""
        shapes_ok = []
        plan = []  # (proof, st, bits)
        lhs_b, lhs_e, lhs_m = [], [], []
        mb, me, mm = [], [], []
        with phase("ringped.challenge", items=len(items)):
            for proof, st in items:
                ok = self._ring_pedersen_gate(proof, st, m_security)
                shapes_ok.append(ok)
                if not ok:
                    continue
                e = RingPedersenProof._challenge(proof.A, self.config.hash_alg)
                bits = challenge_bits(e, m_security, self.config.hash_alg)
                lhs, rhs = RingPedersenProof.rlc_fold(st, proof, bits,
                                                      rlc.sample_rhos(m_security))
                plan.append((proof, st, bits))
                lhs_b.append(lhs[0][0])
                lhs_e.append(lhs[1][0])
                lhs_m.append(lhs[2])
                mb.append(rhs[0])
                me.append(rhs[1])
                mm.append(rhs[2])
        if not plan:
            return [False] * len(items)
        rlc.count("rlc_groups", len(plan))
        rlc.count("rows_folded", len(plan) * m_security)
        rlc.count("fullwidth_ladders", len(plan))
        with phase("ringped.modexp", items=len(plan) * (m_security + 2)):
            lhs_vals, rhs_vals = powm_columns(self._modexp, (lhs_b, lhs_e, lhs_m), (mb, me, mm))

        verdicts = iter(zip(plan, lhs_vals, rhs_vals))
        out = []
        for ok in shapes_ok:
            if not ok:
                out.append(False)
                continue
            (proof, st, bits), lhs, rhs = next(verdicts)
            if lhs == rhs:
                out.append(True)
                continue
            rlc.count("bisect_fallbacks")

            def check(sub, proof=proof, st=st, bits=bits):
                rho = rlc.sample_rhos(len(sub))
                e_merged = sum(r * proof.Z[i] for r, i in zip(rho, sub))
                e_s = sum(r for r, i in zip(rho, sub) if bits[i])
                (rhs,) = multi_powm([tuple(proof.A[i] for i in sub) + (st.S,)],
                                    [tuple(rho) + (e_s,)], [st.N], device=None)
                return intops.mod_pow(st.T % st.N, e_merged, st.N) == rhs

            def row_check(i, proof=proof, st=st, bits=bits):
                return (intops.mod_pow(st.T % st.N, proof.Z[i], st.N)
                        == proof.A[i] * (st.S if bits[i] else 1) % st.N)

            rows = rlc.bisect_rows(range(m_security), check, row_check)
            out.append(all(rows[i] for i in range(m_security)))
        return out

    # ------------------------------------------------------------------
    def _correct_key_gate(self, proof, ek, rounds) -> bool:
        """Wire-ek gate (parity / small-factor / width cap)."""
        n = ek.n
        n_cap = self.config.paillier_bits + 64
        return (
            len(proof.sigma_vec) == rounds
            and n > 0
            and n % 2 == 1
            and n.bit_length() <= n_cap
            and math.gcd(n, correct_key._PRIMORIAL) == 1
            and all(0 < s < n for s in proof.sigma_vec)
        )

    def verify_correct_key(self, items, rounds):
        if not items:
            return []
        if rlc.rlc_enabled():
            return self._correct_key_rlc(items, rounds)
        bases, exps, moduli, want = [], [], [], []
        gates = []
        with phase("correct_key.rho_derive", items=len(items)):
            for proof, ek in items:
                gate = self._correct_key_gate(proof, ek, rounds)
                gates.append(gate)
                if not gate:
                    continue
                n = ek.n
                for i, sigma in enumerate(proof.sigma_vec):
                    bases.append(sigma)
                    exps.append(n)
                    moduli.append(n)
                    want.append(
                        correct_key._derive_rho(
                            n, correct_key.SALT_STRING, i, self.config.hash_alg
                        )
                    )

        with phase("correct_key.modexp", items=len(bases)):
            got = self._modexp(bases, exps, moduli)
        out = []
        row = 0
        for gate in gates:
            if not gate:
                out.append(False)
                continue
            good = all(got[row + i] == want[row + i] for i in range(rounds))
            row += rounds
            out.append(good)
        return out

    def _correct_key_rlc(self, items, rounds):
        """FSDKRC_RLC: each proof's `rounds` checks sigma_i^N == rho_i
        (mod N) fold into (prod sigma_i^r_i)^N == prod rho_i^r_i
        (NiCorrectKeyProof.rlc_fold): phase 1, one joint column of every
        proof's sigma and rho aggregates; phase 2, each sigma-aggregate to
        the N in one generic launch, one full-width chain a proof instead
        of `rounds`. A failing proof bisects on the host."""
        gates = []
        plan = []  # (sigma_vec, want, n, sigma position, target position)
        mb, me, mm = [], [], []
        with phase("correct_key.rho_derive", items=len(items)):
            for proof, ek in items:
                gate = self._correct_key_gate(proof, ek, rounds)
                gates.append(gate)
                if not gate:
                    continue
                n = ek.n
                want = [correct_key._derive_rho(n, correct_key.SALT_STRING, i,
                                                self.config.hash_alg)
                        for i in range(rounds)]
                sig_row, tgt_row = correct_key.NiCorrectKeyProof.rlc_fold(
                    proof.sigma_vec, want, n, rlc.sample_rhos(rounds))
                plan.append((proof.sigma_vec, want, n, len(mm), len(mm) + 1))
                for b, e, m in (sig_row, tgt_row):
                    mb.append(b)
                    me.append(e)
                    mm.append(m)
        if not plan:
            return [False] * len(items)
        rlc.count("rlc_groups", len(plan))
        rlc.count("rows_folded", len(plan) * rounds)
        rlc.count("fullwidth_ladders", len(plan))
        with phase("correct_key.modexp", items=len(plan) * (rounds + 1)):
            (multi_res,) = powm_columns(self._modexp, (mb, me, mm))
            # phase 2: every aggregate to the N-th power, one generic launch
            a_pow = self._modexp([multi_res[g[3]] for g in plan], [g[2] for g in plan],
                                 [g[2] for g in plan])

        verdicts = iter(zip(plan, a_pow))
        out = []
        for gate in gates:
            if not gate:
                out.append(False)
                continue
            (sigma_vec, want, n, _, tgt_pos), ap = next(verdicts)
            if ap == multi_res[tgt_pos]:
                out.append(True)
                continue
            rlc.count("bisect_fallbacks")

            def check(sub, sigma_vec=sigma_vec, want=want, n=n):
                rho = tuple(rlc.sample_rhos(len(sub)))
                sv, wv = multi_powm([tuple(sigma_vec[i] for i in sub), tuple(want[i] for i in sub)],
                                    [rho, rho], [n, n], device=None)
                return intops.mod_pow(sv, n, n) == wv

            def row_check(i, sigma_vec=sigma_vec, want=want, n=n):
                return intops.mod_pow(sigma_vec[i], n, n) == want[i]

            rows = rlc.bisect_rows(range(rounds), check, row_check)
            out.append(all(rows[i] for i in range(rounds)))
        return out

    # ------------------------------------------------------------------
    def verify_composite_dlog(self, items):
        if not items:
            return []
        from ..proofs.composite_dlog import STAT_BITS, CompositeDLogProof

        # the statement (N, g, ni) and proof (x_commit, y) are all wire
        # data: gate the row's domain before transcripts/staging
        n_cap = self.config.paillier_bits + 64
        row_ok = [
            st.N > 2
            and st.N % 2 == 1
            and st.N.bit_length() <= n_cap
            and 0 <= st.g < st.N
            and 0 <= st.ni < st.N
            and 0 < p.x_commit < st.N
            and 0 <= p.y
            and p.y.bit_length() <= st.N.bit_length() + STAT_BITS + 320
            for p, st in items
        ]
        with phase("composite_dlog.challenge", items=len(items)):
            e_vec = [
                CompositeDLogProof._challenge(p.x_commit, st, self.config.hash_alg)
                if ok
                else 0
                for (p, st), ok in zip(items, row_ok)
            ]
        moduli = [st.N if ok else 3 for (_, st), ok in zip(items, row_ok)]
        y_col = [p.y if ok else 0 for (p, _), ok in zip(items, row_ok)]
        with phase("composite_dlog.modexp", items=2 * len(items)):
            g_y = self._modexp([st.g for _, st in items], y_col, moduli)
            ni_e = self._modexp([st.ni for _, st in items], e_vec, moduli)
            lhs = self._modmul(g_y, ni_e, moduli)
        return [
            row_ok[idx] and lhs[idx] == p.x_commit
            for idx, (p, st) in enumerate(items)
        ]

    # ------------------------------------------------------------------
    def validate_feldman(self, items):
        """sum_k A_k * u^k == S_u per row (`src/refresh_message.rs:177-188`),
        as one MSM on the device over every scheme's group
        (`_validate_feldman_device`)."""
        if not items:
            return []
        return self._validate_feldman_device(items)

    def _validate_feldman_device(self, items):
        """Per scheme, with secret 128-bit rho_u over its rows:
            sum_u rho_u*S_u + sum_k (-sum_u rho_u*u^k)*A_k == identity,
        all schemes' groups in one `batch_msm`; the rows of a scheme whose
        sum is not the identity are checked one by one by host Horner
        (the JAX package's TpuBatchVerifier._validate_feldman_device)."""
        groups: Dict[int, List[int]] = {}
        for row, (scheme, _, _) in enumerate(items):
            groups.setdefault(id(scheme), []).append(row)

        group_rows = list(groups.values())
        g_points, g_scalars = [], []
        for rows in group_rows:
            scheme = items[rows[0]][0]
            rho = [secrets.randbits(128) for _ in rows]
            # c_k = sum_u rho_u * u^k with incremental powers (u <= n is
            # small), one reduction at the end
            t1 = len(scheme.commitments)
            c_acc = [0] * t1
            for r, row in zip(rho, rows):
                u = items[row][2]
                pw = r
                for k in range(t1):
                    c_acc[k] += pw
                    pw *= u
            c_vec = [(CURVE_ORDER - c % CURVE_ORDER) % CURVE_ORDER for c in c_acc]
            g_points.append([items[row][1] for row in rows] + list(scheme.commitments))
            g_scalars.append(rho + c_vec)

        combined = ec_batch.batch_msm(g_points, g_scalars, device=self.device)

        out: List[bool] = [False] * len(items)
        for rows, comb in zip(group_rows, combined):
            if comb.infinity:
                verdicts = [True] * len(rows)
            else:
                verdicts = self._host.validate_feldman([items[row] for row in rows])
            for row, v in zip(rows, verdicts):
                out[row] = v
        return out
