"""The refresh protocol: one broadcast message per party + local batch
verification.

Equivalent of the reference's `RefreshMessage`
(`src/refresh_message.rs`): `distribute` (:51-145), `validate_collect`
(:147-191), `get_ciphertext_sum` (:193-237), `replace` (:239-319),
`collect` (:321-467).

Deliberate deviations from the reference (each a conscious fix):
1. `collect` rebuilds pk_vec by assignment, not `Vec::insert` (quirk 1).
2. `distribute` raises an error on t > new_n/2 instead of panicking
   (quirk 2).
3. The ring-Pedersen statement broadcast omits the secret phi (see
   proofs.ring_pedersen).
4. Verification is *batched*: all proof instances are gathered first, one
   batched verify per proof family runs (host or device backend), and
   failures are then attributed to parties in the reference's original
   loop order — same first-error semantics, batch execution.
   `collect` is one session of `collect_sessions`, which fuses the
   families of many independent sessions into one launch set each.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

from ..backend import get_backend
from ..config import ProtocolConfig, DEFAULT_CONFIG
from ..core import paillier, vss
from ..core.paillier import DecryptionKey, EncryptionKey
from ..core.secp256k1 import GENERATOR, Point, Scalar
from ..ops import ec_batch
from ..errors import (
    BroadcastedPublicKeyError,
    DLogProofValidation,
    ModuliTooSmall,
    NewPartyUnassignedIndexError,
    PaillierVerificationError,
    PartiesThresholdViolation,
    PDLwSlackProofError,
    PublicShareValidationError,
    RangeProofError,
    RingPedersenProofError,
    SizeMismatchError,
)
from ..proofs.alice_range import AliceProof
from ..proofs.composite_dlog import DLogStatement
from ..proofs.correct_key import NiCorrectKeyProof
from ..proofs.pdl_slack import PDLwSlackProof, PDLwSlackStatement, PDLwSlackWitness
from ..proofs.ring_pedersen import RingPedersenProof, RingPedersenStatement
from ..telemetry.spans import phase
from .local_key import LocalKey

if TYPE_CHECKING:
    from .join import JoinMessage
    from .streaming import StreamingCollect


@dataclass
class RefreshMessage:
    """The broadcast message; field set mirrors
    `src/refresh_message.rs:31-48` ("everything here can be broadcasted")."""

    old_party_index: int
    party_index: int
    pdl_proof_vec: List[PDLwSlackProof]
    range_proofs: List[AliceProof]
    coefficients_committed_vec: vss.VerifiableSS
    points_committed_vec: List[Point]
    points_encrypted_vec: List[int]
    dk_correctness_proof: NiCorrectKeyProof
    dlog_statement: DLogStatement
    ek: EncryptionKey
    remove_party_indices: List[int]
    public_key: Point
    ring_pedersen_statement: RingPedersenStatement
    ring_pedersen_proof: RingPedersenProof

    # ------------------------------------------------------------------
    @staticmethod
    def distribute(
        old_party_index: int,
        local_key: LocalKey,
        new_n: int,
        config: ProtocolConfig = DEFAULT_CONFIG,
    ) -> Tuple["RefreshMessage", DecryptionKey]:
        """Sender path (reference :51-145). Mutates local_key.vss_scheme.

        Returns the broadcast message and the *new* Paillier decryption key,
        which the caller feeds back into `collect`.
        """
        return RefreshMessage.distribute_batch(
            [(old_party_index, local_key)], new_n, config
        )[0]

    @staticmethod
    def distribute_batch(
        senders: Sequence[Tuple[int, LocalKey]],
        new_n: int,
        config: ProtocolConfig = DEFAULT_CONFIG,
    ) -> List[Tuple["RefreshMessage", DecryptionKey]]:
        """All senders' paths as fused cross-party batches: the
        per-receiver columns of every sender concatenate into ONE launch
        per proof family and width. Mutates each local_key.vss_scheme.

        A committee with pool targets (`precompute.prefill`, or the
        serving planner's under `precompute.owner_scope`) takes the pooled
        branch: every phase boundary consumes or computes, pooled rows
        taking their offline-produced values (the values inline sampling
        and computing would give), dry rows that phase's inline columns.
        Any other committee distributes inline and touches no pool."""
        # the root prover span: every distribute.* phase (and the engine
        # spans they fan out) nests under it in the trace
        with phase("distribute", items=len(senders) * new_n,
                   senders=len(senders), new_n=new_n):
            return RefreshMessage._distribute_batch_impl(senders, new_n, config)

    @staticmethod
    def _distribute_batch_impl(
        senders: Sequence[Tuple[int, LocalKey]],
        new_n: int,
        config: ProtocolConfig = DEFAULT_CONFIG,
    ) -> List[Tuple["RefreshMessage", DecryptionKey]]:
        from ..backend.powm import get_batch_powm, powm_columns
        from .. import precompute

        powm = get_batch_powm(config)
        ec_device = _ec_device(config)

        # validate every sender BEFORE the first mutation: a late failure
        # must not leave earlier senders' vss_scheme replaced by schemes
        # whose shares were never broadcast
        for _, local_key in senders:
            t = local_key.t
            if t > new_n // 2:
                raise PartiesThresholdViolation(threshold=t, refreshed_keys=new_n)
            if new_n <= t:
                raise NewPartyUnassignedIndexError()

        # the committee's owner: the serving layer's explicit scope, or
        # the stable mod-N~ fingerprint `prefill` registers under
        owner = precompute.current_registration_owner()
        if owner is None:
            owner = precompute.committee_owner(senders[0][1].h1_h2_n_tilde_vec[:new_n])
        pooled_keys = precompute.claim(owner)
        pre_on = pooled_keys is not None

        per = []  # per-sender working state, in input order
        for old_party_index, local_key in senders:
            coeffs, secret_shares = vss.sample_poly(
                local_key.t, new_n, local_key.keys_linear.x_i
            )
            receiver_eks = [local_key.paillier_key_vec[i] for i in range(new_n)]
            rand, rn = [], []  # pooled r^n mod n^2 per receiver (None: inline)
            for ek_i in receiver_eks:
                ent = precompute.take("enc", ek_i.n) if pre_on else None
                if ent is None:
                    rand.append(paillier.sample_randomness(ek_i))
                    rn.append(None)
                else:
                    rand.append(ent[0])
                    rn.append(ent[1])
            per.append(
                dict(
                    old_i=old_party_index,
                    key=local_key,
                    coeffs=coeffs,
                    shares=secret_shares,
                    eks=receiver_eks,
                    rand=rand,
                    rn=rn,
                )
            )

        # Feldman coefficient commitments A_k = a_k * G: all senders' in
        # one device launch on the cuda backend
        flat_coeff_points = ec_batch.generator_muls(
            [c.to_int() for p in per for c in p["coeffs"]], ec_device
        )
        pos = 0
        for p in per:
            cnt = len(p["coeffs"])
            p["scheme"] = vss.VerifiableSS(
                vss.ShamirSecretSharing(p["key"].t, new_n),
                flat_coeff_points[pos : pos + cnt],
            )
            pos += cnt
            del p["coeffs"]  # polynomial coefficients are secret round state
            p["key"].vss_scheme = p["scheme"]

        # flattened share ints, reused by the commit points and the
        # encryption column below (holds secret material)
        flat_share_ints = [s.to_int() for p in per for s in p["shares"]]

        # commit points S_i = sigma_i * G (reference :67-69): one device
        # launch across all (sender, receiver) pairs on the cuda backend
        with phase("distribute.commit_points", items=len(flat_share_ints)):
            flat_points = ec_batch.generator_muls(flat_share_ints, ec_device)
        for k, p in enumerate(per):
            p["points"] = flat_points[k * new_n : (k + 1) * new_n]

        # ---- fused prover columns over all (sender, receiver) pairs: the
        # encryption column and BOTH proof families' stage-1 commitment
        # columns share launches by width, then both families' r^e
        # response columns share the stage-2 launch
        flat_rand = [r for p in per for r in p["rand"]]
        flat_rn = [x for p in per for x in p["rn"]]
        flat_nv = [ek.n for p in per for ek in p["eks"]]
        flat_nnv = [ek.nn for p in per for ek in p["eks"]]
        flat_h1 = [p["key"].h1_h2_n_tilde_vec[i].g for p in per for i in range(new_n)]
        flat_h2 = [p["key"].h1_h2_n_tilde_vec[i].ni for p in per for i in range(new_n)]
        flat_nt = [p["key"].h1_h2_n_tilde_vec[i].N for p in per for i in range(new_n)]
        flat_witnesses = [
            PDLwSlackWitness(x=s, r=r)
            for p in per
            for s, r in zip(p["shares"], p["rand"])
        ]

        # both provers return their Paillier beta^n column LAST, so the
        # full-width public-exponent columns (enc r^n + both beta^n) stay
        # in one launch set and the mod-N~ columns in the other. Pooled
        # rows drop out of both (their powers were produced offline);
        # only the witness factor h1^x, shared by both families, and any
        # dry rows stay online
        with phase("distribute.prove_stage1", items=len(flat_rand)):
            pooled_pdl = pooled_alice = None
            with phase("distribute.stage1.sample", items=len(flat_rand)):
                if pre_on:
                    envs = list(zip(flat_h1, flat_h2, flat_nt, flat_nv))
                    pooled_pdl = [precompute.take("pdl", e) for e in envs]
                    pooled_alice = [precompute.take("alice", e) for e in envs]
                    # the receivers' keys rotate with this epoch: what their
                    # pools have left can never be taken
                    precompute.release(pooled_keys)
                pdl_state, pdl_cols = PDLwSlackProof.prove_stage1(
                    flat_witnesses, flat_h1, flat_h2, flat_nt, flat_nv, flat_nnv,
                    hash_alg=config.hash_alg, pooled=pooled_pdl,
                )
                alice_state, alice_cols = AliceProof.generate_stage1(
                    flat_share_ints, flat_rand, flat_h1, flat_h2, flat_nt,
                    flat_nv, flat_nnv, hash_alg=config.hash_alg, pooled=pooled_alice,
                )
            # the encryption column r^n mod n^2: rows without a pooled power
            enc_fb = [i for i, x in enumerate(flat_rn) if x is None]
            enc_col = (
                [flat_rand[i] for i in enc_fb],
                [flat_nv[i] for i in enc_fb],
                [flat_nnv[i] for i in enc_fb],
            )
            with phase("distribute.stage1.enc_beta_pow",
                       items=len(enc_col[0]) + len(pdl_cols[-1][0]) + len(alice_cols[-1][0])):
                res_pail = powm_columns(powm, enc_col, pdl_cols[-1], alice_cols[-1])
            with phase("distribute.stage1.commit_pow",
                       items=sum(len(c[0]) for c in pdl_cols[:-1] + alice_cols[:-1])):
                res_commit = powm_columns(powm, *pdl_cols[:-1], *alice_cols[:-1])
            n_pdl = len(pdl_cols)
            pdl_res1 = res_commit[: n_pdl - 1] + [res_pail[1]]
            alice_res1 = res_commit[n_pdl - 1 :] + [res_pail[2]]
            rn_full = list(flat_rn)
            for j, i in enumerate(enc_fb):
                rn_full[i] = res_pail[0][j]

        # ciphertexts from the fused encryption column (randomness is
        # unit-sampled, inline or by the producer)
        with phase("distribute.encrypt", items=len(flat_share_ints)):
            flat_enc = paillier.combine_with_rn(
                flat_share_ints, rn_full, flat_nv, flat_nnv
            )
        # (the share ints also live on as alice_state["avals"] until the
        # proofs are assembled — same round-state lifetime as the nonces)
        del flat_share_ints
        for k, p in enumerate(per):
            p["enc"] = flat_enc[k * new_n : (k + 1) * new_n]

        flat_statements = [
            PDLwSlackStatement(
                ciphertext=p["enc"][i],
                ek=p["eks"][i],
                Q=p["points"][i],
                G=GENERATOR,
                h1=p["key"].h1_h2_n_tilde_vec[i].g,
                h2=p["key"].h1_h2_n_tilde_vec[i].ni,
                N_tilde=p["key"].h1_h2_n_tilde_vec[i].N,
            )
            for p in per
            for i in range(new_n)
        ]

        with phase("distribute.prove_stage2", items=len(flat_rand)):
            pdl_state, pdl_cols2 = PDLwSlackProof.prove_stage2(
                pdl_state, pdl_res1, flat_statements, ec_device
            )
            alice_state, alice_cols2 = AliceProof.generate_stage2(
                alice_state, alice_res1, flat_enc
            )
            res2 = powm_columns(powm, *pdl_cols2, *alice_cols2)
            flat_pdl = PDLwSlackProof.prove_finish(pdl_state, res2[: len(pdl_cols2)])
            flat_range = AliceProof.generate_finish(
                alice_state, res2[len(pdl_cols2) :]
            )

        # ---- per-sender key material: pooled bundles first (complete
        # offline ek/dk, correct-key proof, ring-Pedersen statement and
        # proof — every part a function of the fresh key alone), then the
        # rest inline: the native prime pipeline and both provers'
        # columns
        key_bundles: list = []
        if pre_on:
            kp = config.key_material_pool_key
            for _ in per:
                b = precompute.take("keys", kp)
                if b is None:
                    break  # dry: the remaining senders compute inline
                key_bundles.append(b)
        # the phases' items are the inline rows alone (a pooled bundle
        # costs a pop, not a keygen)
        miss = len(per) - len(key_bundles)
        ek_dk_inline, rp_inline, ck_inline, rp_proofs_inline = [], [], [], []
        with phase("distribute.keygen", items=miss):
            if miss:
                ek_dk_inline = paillier.keygen_batch(config.paillier_bits, miss)
        with phase("distribute.ring_pedersen_gen", items=miss):
            if miss:
                rp_inline = RingPedersenStatement.generate_batch(miss, config)
        with phase("distribute.correct_key_prove", items=miss):
            if miss:
                ck_inline = NiCorrectKeyProof.proof_batch(
                    [dk for _, dk in ek_dk_inline],
                    rounds=config.correct_key_rounds,
                    powm=powm, hash_alg=config.hash_alg,
                )
        with phase("distribute.ring_pedersen_prove", items=miss):
            if miss:
                rp_proofs_inline = RingPedersenProof.prove_batch(
                    [w for _, w in rp_inline], [st for st, _ in rp_inline],
                    config.m_security, powm, config.hash_alg,
                )
        # pooled bundles fill the first senders (take order), inline
        # results the rest — deterministic, so seeded runs assign the
        # same material to each sender
        ek_dk = [(b[0], b[1]) for b in key_bundles] + ek_dk_inline
        ck_proofs = [b[2] for b in key_bundles] + ck_inline
        rp_statements = [b[3] for b in key_bundles] + [st for st, _ in rp_inline]
        rp_proofs = [b[4] for b in key_bundles] + rp_proofs_inline

        out = []
        for k, p in enumerate(per):
            local_key = p["key"]
            msg = RefreshMessage(
                old_party_index=p["old_i"],
                party_index=local_key.i,
                pdl_proof_vec=flat_pdl[k * new_n : (k + 1) * new_n],
                range_proofs=flat_range[k * new_n : (k + 1) * new_n],
                coefficients_committed_vec=p["scheme"],
                points_committed_vec=p["points"],
                points_encrypted_vec=p["enc"],
                dk_correctness_proof=ck_proofs[k],
                dlog_statement=local_key.h1_h2_n_tilde_vec[local_key.i - 1],
                ek=ek_dk[k][0],
                remove_party_indices=[],
                public_key=local_key.y_sum_s,
                ring_pedersen_statement=rp_statements[k],
                ring_pedersen_proof=rp_proofs[k],
            )
            out.append((msg, ek_dk[k][1]))
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def validate_collect(
        refresh_messages: Sequence["RefreshMessage"],
        t: int,
        n: int,
        config: ProtocolConfig = DEFAULT_CONFIG,
    ) -> None:
        """Structure checks + batched Feldman validation (reference :147-191)."""
        if len(refresh_messages) <= t:
            raise PartiesThresholdViolation(
                threshold=t, refreshed_keys=len(refresh_messages)
            )

        # every per-receiver vector must cover the full new committee; the
        # reference only compares against messages[0]'s length
        # (src/refresh_message.rs:157-175), which can crash the Feldman loop
        # below or misattribute blame — we check against n directly
        for k, msg in enumerate(refresh_messages):
            lens = (
                len(msg.pdl_proof_vec),
                len(msg.points_committed_vec),
                len(msg.points_encrypted_vec),
            )
            if any(l != n for l in lens) or len(msg.range_proofs) != n:
                raise SizeMismatchError(k, *lens)

        backend = get_backend(config)
        items = [
            (msg.coefficients_committed_vec, msg.points_committed_vec[i], i + 1)
            for msg in refresh_messages
            for i in range(n)
        ]
        if not all(backend.validate_feldman(items)):
            raise PublicShareValidationError()

    # ------------------------------------------------------------------
    @staticmethod
    def get_ciphertext_sum(
        refresh_messages: Sequence["RefreshMessage"],
        party_index: int,
        parameters: vss.ShamirSecretSharing,
        ek: EncryptionKey,
    ) -> Tuple[int, List[Scalar]]:
        """Homomorphic Lagrange combination of the first t+1 senders'
        ciphertext columns addressed to `party_index` — the "one
        decryption" optimization (reference :193-237)."""
        t = parameters.threshold
        ciphertexts = [
            msg.points_encrypted_vec[party_index - 1] for msg in refresh_messages
        ]
        indices = [msg.old_party_index - 1 for msg in refresh_messages[: t + 1]]
        li_vec = [
            vss.map_share_to_new_params(parameters, indices[i], indices)
            for i in range(t + 1)
        ]
        acc = paillier.encrypt(ek, 0)
        for i in range(t + 1):
            acc = paillier.add(ek, acc, paillier.mul(ek, ciphertexts[i], li_vec[i].to_int()))
        return acc, li_vec

    # ------------------------------------------------------------------
    @staticmethod
    def interpolate_constant_term(
        refresh_messages: Sequence["RefreshMessage"],
        li_vec: Sequence[Scalar],
        t: int,
    ) -> Point:
        """sum_j lambda_j * A_0^{(j)} over the first t+1 senders' Feldman
        constant-term commitments. Each A_0^{(j)} commits to sender j's
        OLD share x_j, so with honest Lagrange weights this re-derives
        the (unchanged) group public key — the hardening gate collect
        compares against y (reference quirk 4 / TODO at
        src/refresh_message.rs:199 leaves the broadcast old_party_index
        untrusted-but-unchecked)."""
        acc = refresh_messages[0].coefficients_committed_vec.commitments[0] * li_vec[0]
        for j in range(1, t + 1):
            acc = acc + (
                refresh_messages[j].coefficients_committed_vec.commitments[0]
                * li_vec[j]
            )
        return acc

    # ------------------------------------------------------------------
    @staticmethod
    def replace(
        new_parties: Sequence["JoinMessage"],
        key: LocalKey,
        old_to_new_map: Dict[int, int],
        new_n: int,
        config: ProtocolConfig = DEFAULT_CONFIG,
    ) -> Tuple["RefreshMessage", DecryptionKey]:
        """State surgery for index remapping + joins, then an ordinary
        distribute (reference :239-319)."""
        # pools that `precompute.prefill` filled for this committee are
        # keyed by the pre-churn committee layout (receiver moduli and
        # mod-N~ environments); the surgery below changes that layout, so
        # those single-use entries can never be taken: wipe them now
        from .. import precompute

        precompute.invalidate_owner(precompute.committee_owner(key.h1_h2_n_tilde_vec))
        size = max(new_n, len(key.paillier_key_vec))
        new_ek_vec: List[Optional[EncryptionKey]] = [None] * size
        new_dlog_vec: List[Optional[DLogStatement]] = [None] * size

        for old_idx, new_idx in old_to_new_map.items():
            new_ek_vec[new_idx - 1] = key.paillier_key_vec[old_idx - 1]
            new_dlog_vec[new_idx - 1] = key.h1_h2_n_tilde_vec[old_idx - 1]

        for join in new_parties:
            idx = join.get_party_index()
            new_ek_vec[idx - 1] = join.ek
            new_dlog_vec[idx - 1] = join.dlog_statement

        # slots not covered by the map or a join keep their old entry
        # (mirrors the reference's in-place writes)
        for slot in range(size):
            if new_ek_vec[slot] is None and slot < len(key.paillier_key_vec):
                new_ek_vec[slot] = key.paillier_key_vec[slot]
                new_dlog_vec[slot] = key.h1_h2_n_tilde_vec[slot]
        if any(v is None for v in new_ek_vec[:new_n]):
            raise NewPartyUnassignedIndexError()

        key.paillier_key_vec = list(new_ek_vec[:new_n])
        key.h1_h2_n_tilde_vec = list(new_dlog_vec[:new_n])

        old_party_index = key.i
        key.i = old_to_new_map[key.i]
        key.n = new_n

        return RefreshMessage.distribute(old_party_index, key, new_n, config)

    # ------------------------------------------------------------------
    @staticmethod
    def collect(
        refresh_messages: Sequence["RefreshMessage"],
        local_key: LocalKey,
        new_dk: DecryptionKey,
        join_messages: Sequence["JoinMessage"] = (),
        config: ProtocolConfig = DEFAULT_CONFIG,
    ) -> None:
        """Receiver path — the O(n^2) verification loop, executed as
        per-family batches (reference :321-467), for one session: the
        new committee is the senders plus `join_messages`. One session of
        `collect_sessions`; raises the first error in the reference's
        check order; on success rotates local_key."""
        err = RefreshMessage.collect_sessions(
            [(refresh_messages, local_key, new_dk, tuple(join_messages))], config
        )[0]
        if err is not None:
            raise err

    @staticmethod
    def collect_stream(
        local_key: LocalKey,
        new_dk: DecryptionKey,
        expected_senders: Optional[Sequence[int]] = None,
        join_messages: Sequence["JoinMessage"] = (),
        config: ProtocolConfig = DEFAULT_CONFIG,
    ) -> "StreamingCollect":
        """Streaming counterpart of `collect`: a StreamingCollect session
        that verifies broadcast messages as they are `offer`ed (the
        structural gates and the per-message families, Feldman,
        ring-Pedersen and correct-key, eagerly; the pair families' RLC
        fold at quorum, in `finalize()`). Verdicts, blame and LocalKey
        mutation are those of barrier `collect` on the same messages in
        `expected_senders` order (default: the committee's indices
        1..n). See protocol.streaming."""
        from .streaming import StreamingCollect

        return StreamingCollect(local_key, new_dk, expected_senders, join_messages, config)

    @staticmethod
    def collect_sessions(
        sessions: Sequence[
            Tuple[
                Sequence["RefreshMessage"],
                LocalKey,
                DecryptionKey,
                Sequence["JoinMessage"],
            ]
        ],
        config: ProtocolConfig = DEFAULT_CONFIG,
    ) -> List[Optional[Exception]]:
        """collect() for many INDEPENDENT sessions (messages, key, new dk,
        joins), each verification family fused across sessions into one
        launch set: BASELINE.json config 5's 64 n=16 sessions feed the row
        axis one n=256 session would. Per session the semantics are
        `collect`'s: the same check order, error types and LocalKey
        mutation points. Returns one entry per session: None on success,
        else the exception `collect` would have raised. A failing session
        never blocks the others: a fused call that raises is retried one
        session at a time (`fused_isolated`)."""
        # the root verifier span; the collect.* family phases
        # (TracedVerifier) and their engine spans nest under it
        with phase("collect", items=len(sessions), sessions=len(sessions)):
            return RefreshMessage._collect_sessions_impl(sessions, config)

    @staticmethod
    def _collect_sessions_impl(sessions, config: ProtocolConfig) -> List[Optional[Exception]]:
        backend = get_backend(config)
        count = len(sessions)
        errors: List[Optional[Exception]] = [None] * count
        new_ns: List[int] = [len(msgs) + len(joins) for msgs, _, _, joins in sessions]

        def alive():
            return [s for s in range(count) if errors[s] is None]

        def fused(call, items, spans):
            return fused_isolated(lambda lst: (call(lst),), (items,), spans, errors)[0]

        # ---- structure checks + fused Feldman validation (reference
        # :147-191)
        feld_items: list = []
        feld_spans: Dict[int, Tuple[int, int]] = {}
        for s, (msgs, key, _dk, _joins) in enumerate(sessions):
            try:
                check_structure(msgs, key, new_ns[s])
            except Exception as e:
                errors[s] = e
                continue
            lo = len(feld_items)
            feld_items.extend(
                (msg.coefficients_committed_vec, msg.points_committed_vec[i], i + 1)
                for msg in msgs
                for i in range(new_ns[s])
            )
            feld_spans[s] = (lo, len(feld_items))
        if feld_items:
            # Feldman verdicts are row-local, so the memory plan's tiles
            # cannot change one
            feld_verdicts = fused(
                lambda items: _feldman_streamed(backend, items), feld_items, feld_spans
            )
            for s, (lo, hi) in feld_spans.items():
                if errors[s] is None and not all(feld_verdicts[lo:hi]):
                    errors[s] = PublicShareValidationError()

        # ---- the O(n^2) PDL + range instances of every session, one
        # fused launch set
        pdl_items: list = []
        range_items: list = []
        pair_spans: Dict[int, Tuple[int, int]] = {}
        for s in alive():
            msgs, key, _dk, _joins = sessions[s]
            lo = len(pdl_items)
            for msg in msgs:
                for i in range(new_ns[s]):
                    st = PDLwSlackStatement(
                        ciphertext=msg.points_encrypted_vec[i],
                        ek=key.paillier_key_vec[i],
                        Q=msg.points_committed_vec[i],
                        G=GENERATOR,
                        h1=key.h1_h2_n_tilde_vec[i].g,
                        h2=key.h1_h2_n_tilde_vec[i].ni,
                        N_tilde=key.h1_h2_n_tilde_vec[i].N,
                    )
                    pdl_items.append((msg.pdl_proof_vec[i], st))
                    range_items.append(
                        (
                            msg.range_proofs[i],
                            msg.points_encrypted_vec[i],
                            key.paillier_key_vec[i],
                            key.h1_h2_n_tilde_vec[i],
                        )
                    )
            pair_spans[s] = (lo, len(pdl_items))
        if pdl_items:
            # the session spans (cross-session dedup, session-first blame)
            # go ONLY with the full fused call: fused_isolated's retries
            # are single-session slices
            def pairs_call(p_slice, r_slice):
                if len(p_slice) == len(pdl_items):
                    return backend.verify_pairs(p_slice, r_slice, session_spans=pair_spans)
                return backend.verify_pairs(p_slice, r_slice)

            pdl_verdicts, range_verdicts = fused_isolated(
                pairs_call, (pdl_items, range_items), pair_spans, errors
            )
            for s, (start, _hi) in pair_spans.items():
                if errors[s] is not None:
                    continue
                try:
                    pair_blame(sessions[s][0], new_ns[s], pdl_verdicts, range_verdicts, start)
                except Exception as e:
                    errors[s] = e

        # ---- ring-Pedersen (reference :352-365) -----------------------
        rp_items: list = []
        rp_spans: Dict[int, Tuple[int, int]] = {}
        for s in alive():
            msgs, _key, _dk, joins = sessions[s]
            lo = len(rp_items)
            rp_items += [(m.ring_pedersen_proof, m.ring_pedersen_statement) for m in msgs]
            rp_items += [(j.ring_pedersen_proof, j.ring_pedersen_statement) for j in joins]
            rp_spans[s] = (lo, len(rp_items))
        if rp_items:
            rp_verdicts = fused(
                lambda items: backend.verify_ring_pedersen(items, config.m_security),
                rp_items,
                rp_spans,
            )
            for s, (lo, hi) in rp_spans.items():
                if errors[s] is None and not all(rp_verdicts[lo:hi]):
                    errors[s] = RingPedersenProofError()

        # ---- share recovery inputs (reference :367-373) ---------------
        recovered: Dict[int, tuple] = {}
        with phase("collect.share_recovery", items=len(alive())):
            for s in alive():
                msgs, key, _dk, _joins = sessions[s]
                try:
                    recovered[s] = share_recovery_check(msgs, key)
                except Exception as e:
                    errors[s] = e

        # ---- Paillier correct-key + composite dlog, fused -------------
        ck_items: list = []
        ck_spans: Dict[int, Tuple[int, int]] = {}
        dlog_items: list = []
        dlog_spans: Dict[int, Tuple[int, int]] = {}
        for s in alive():
            msgs, _key, _dk, joins = sessions[s]
            lo = len(ck_items)
            ck_items += [(m.dk_correctness_proof, m.ek) for m in msgs]
            ck_items += [(j.dk_correctness_proof, j.ek) for j in joins]
            ck_spans[s] = (lo, len(ck_items))
            lo = len(dlog_items)
            # each join's statement in both base directions (reference
            # :415-425): (N, h1, h2) and its inverse (N, h2, h1)
            for join in joins:
                st = join.dlog_statement
                dlog_items.append((join.composite_dlog_proof_base_h1, st))
                dlog_items.append(
                    (join.composite_dlog_proof_base_h2, DLogStatement(N=st.N, g=st.ni, ni=st.g))
                )
            dlog_spans[s] = (lo, len(dlog_items))
        ck_verdicts = (
            fused(
                lambda items: backend.verify_correct_key(items, config.correct_key_rounds),
                ck_items,
                ck_spans,
            )
            if ck_items
            else []
        )
        dlog_verdicts = (
            fused(backend.verify_composite_dlog, dlog_items, dlog_spans) if dlog_items else []
        )

        # ---- adoption, session by session, in session order: the
        # mutation points of collect (a failure part-way leaves the
        # reference's partial paillier_key_vec)
        with phase("collect.adopt", items=len(alive())):
            for s in alive():
                msgs, local_key, new_dk, joins = sessions[s]
                ck0, ck1 = ck_spans[s]
                d0, d1 = dlog_spans[s]
                try:
                    adopt_session(
                        msgs, local_key, new_dk, joins, ck_verdicts[ck0:ck1],
                        dlog_verdicts[d0:d1], recovered[s], new_ns[s], config,
                    )
                except Exception as e:
                    errors[s] = e
        return errors


def _feldman_streamed(backend, items):
    """validate_feldman under the memory plan (backend.memplan.streamed_rows):
    the EC row axis verified tile by tile, so the Feldman columns never
    stage the whole n^2 point set at once. A one-tile plan calls
    through."""
    from ..backend import memplan

    return memplan.streamed_rows(backend.validate_feldman, items, memplan.ec_row_bytes(),
                                 "feldman", getattr(backend, "device", None))


def fused_isolated(call, lists, spans, errors):
    """One fused backend call over parallel item lists sharing the session
    spans; if the fused call raises (a malformed session: a proof field
    the batch cannot stage), each live session is retried alone, on the
    same backend, so the bad session gets the error and the others still
    verify. `errors` is the per-session error slate: a session whose retry
    raises gets that exception there, and its rows stay None. Returns one
    verdict list per input list."""
    try:
        return call(*lists)
    except Exception:
        outs = tuple([None] * len(lst) for lst in lists)
        for s, (lo, hi) in spans.items():
            if errors[s] is not None:
                continue
            try:
                res = call(*(lst[lo:hi] for lst in lists))
                for out, part in zip(outs, res):
                    out[lo:hi] = part
            except Exception as e:
                errors[s] = e
        return outs


# ---------------------------------------------------------------------------
# collect stages


def check_structure(msgs: Sequence["RefreshMessage"], key: LocalKey, new_n: int) -> None:
    """Threshold + per-message wire-shape + broadcast-public-key gates
    (reference :147-191 plus the quirk-5 generalization), first error in
    message order."""
    if len(msgs) <= key.t:
        raise PartiesThresholdViolation(
            threshold=key.t, refreshed_keys=len(msgs)
        )
    for k, msg in enumerate(msgs):
        lens = (
            len(msg.pdl_proof_vec),
            len(msg.points_committed_vec),
            len(msg.points_encrypted_vec),
        )
        if any(l != new_n for l in lens) or len(msg.range_proofs) != new_n:
            raise SizeMismatchError(k, *lens)
        # the reference gates broadcast public_key only on the join path
        # (add_party_message.rs:268-274, quirk 5); here an existing party
        # knows the true group key, so gate every broadcast against it
        if msg.public_key != key.y_sum_s:
            raise BroadcastedPublicKeyError(msg.party_index)


def pair_blame(
    msgs: Sequence["RefreshMessage"],
    new_n: int,
    pdl_verdicts: Sequence,
    range_verdicts: Sequence,
    start: int = 0,
) -> None:
    """Attribute pair-loop failures in the reference's loop order (msg
    outer, i inner; PDL before range — src/refresh_message.rs:330-350).
    The PDL error names the sender whose proof failed."""
    row = start
    for msg in msgs:
        for i in range(new_n):
            if pdl_verdicts[row] is not None:
                raise PDLwSlackProofError(
                    *pdl_verdicts[row], party_index=msg.party_index
                )
            if not range_verdicts[row]:
                raise RangeProofError(party_index=i)
            row += 1


def share_recovery_check(
    msgs: Sequence["RefreshMessage"], key: LocalKey
) -> Tuple[EncryptionKey, int, List[Scalar]]:
    """Homomorphic share-recovery inputs + the constant-term Lagrange
    gate (reference :367-373 plus the quirk-4 hardening): the Lagrange
    weights must re-derive the unchanged group key, or a lying/
    duplicated old_party_index silently rotates the committee onto a
    DIFFERENT secret (see interpolate_constant_term)."""
    old_ek = key.paillier_key_vec[key.i - 1]
    cipher_sum, li_vec = RefreshMessage.get_ciphertext_sum(
        msgs, key.i, key.vss_scheme.parameters, old_ek
    )
    y_check = RefreshMessage.interpolate_constant_term(msgs, li_vec, key.t)
    if y_check != key.y_sum_s:
        raise PublicShareValidationError()
    return old_ek, cipher_sum, li_vec


def adopt_session(
    msgs: Sequence["RefreshMessage"],
    local_key: LocalKey,
    new_dk: DecryptionKey,
    joins: Sequence["JoinMessage"],
    ck_verdicts: Sequence[bool],
    dlog_verdicts: Sequence[bool],
    recovered: Tuple[EncryptionKey, int, List[Scalar]],
    new_n: int,
    config: ProtocolConfig,
) -> None:
    """The mutating adoption phase (reference :375-467): correct-key/dlog
    verdict gates, moduli-size gates, paillier_key_vec installs, own-share
    decrypt + Feldman consistency gate, key rotation. `ck_verdicts` covers
    msgs then joins; `dlog_verdicts` two per join. A failure mid-way
    leaves the same partial paillier_key_vec updates the reference would."""
    for k, msg in enumerate(msgs):
        if not ck_verdicts[k]:
            raise PaillierVerificationError(party_index=msg.party_index)
        n_len = msg.ek.n.bit_length()
        if n_len > config.paillier_bits or n_len < config.paillier_bits - 1:
            raise ModuliTooSmall(
                party_index=msg.party_index, moduli_size=n_len
            )
        local_key.paillier_key_vec[msg.party_index - 1] = msg.ek

    for k, join in enumerate(joins):
        party_index = join.get_party_index()
        if not ck_verdicts[len(msgs) + k]:
            raise PaillierVerificationError(party_index=party_index)
        if not (dlog_verdicts[2 * k] and dlog_verdicts[2 * k + 1]):
            raise DLogProofValidation(party_index=party_index)
        n_len = join.ek.n.bit_length()
        if n_len > config.paillier_bits or n_len < config.paillier_bits - 1:
            raise ModuliTooSmall(
                party_index=party_index, moduli_size=n_len
            )
        local_key.paillier_key_vec[party_index - 1] = join.ek

    # ---- decrypt own new share; rotate key material -------------------
    old_ek, cipher_sum, li_vec = recovered
    new_share = paillier.decrypt(local_key.paillier_dk, old_ek, cipher_sum)
    new_share_fe = Scalar.from_int(new_share)

    # pk_vec rebuild by assignment — conscious fix of quirk 1
    # (reference :455-464 uses Vec::insert)
    pk_vec = combine_committed_points(
        msgs, li_vec, local_key.t, new_n, _ec_device(config)
    )

    # consistency gate absent from the reference: the decrypted share
    # must match the Feldman-committed public share, or the key would be
    # silently corrupted (e.g. by a plaintext wrap mod a too-small
    # Paillier modulus)
    if GENERATOR * new_share_fe != pk_vec[local_key.i - 1]:
        raise PublicShareValidationError()

    # zeroize the old dk, install the new one (reference :445-448)
    local_key.paillier_dk.zeroize()
    local_key.paillier_dk = new_dk

    local_key.keys_linear.x_i = new_share_fe
    local_key.keys_linear.y = GENERATOR * new_share_fe
    local_key.pk_vec = pk_vec


def _ec_device(config: ProtocolConfig):
    """The torch device of the protocol's EC batches: the configured one
    on the cuda backend, None (the host) on the host backend."""
    return config.torch_device() if config.backend == "cuda" else None


def combine_committed_points(
    refresh_messages: Sequence["RefreshMessage"],
    li_vec: Sequence[Scalar],
    t: int,
    n: int,
    device=None,
) -> List[Point]:
    """X_i = sum_{j=0..t} lambda_j * S_i^{(j)} over the first t+1 senders'
    committed points, shared by refresh collect (reference :455-464) and
    join collect (`src/add_party_message.rs:203-212`). On `device`, one `batch_msm`
    (n groups of t+1 rows: one scalar-mul and one tree-sum launch); with
    device None, on the host."""
    if device is not None:
        scalars = [li.to_int() for li in li_vec[: t + 1]]
        return ec_batch.batch_msm(
            [
                [refresh_messages[j].points_committed_vec[i] for j in range(t + 1)]
                for i in range(n)
            ],
            [scalars] * n,
            device=device,
        )
    pk_vec = []
    for i in range(n):
        acc = refresh_messages[0].points_committed_vec[i] * li_vec[0]
        for j in range(1, t + 1):
            acc = acc + refresh_messages[j].points_committed_vec[i] * li_vec[j]
        pk_vec.append(acc)
    return pk_vec
