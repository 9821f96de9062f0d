"""Join (add/replace party) protocol messages.

Equivalent of the reference's `JoinMessage`
(`src/add_party_message.rs`): a new party broadcasts its
Paillier key + correctness proof + dlog statement/proofs + ring-Pedersen
parameters, is assigned an index out-of-band, and derives its first
LocalKey from the refresh broadcast.

Reference behavior preserved deliberately: the joining party does NOT
verify the O(n^2) PDL/range proofs — only ring-Pedersen and structure
checks — trusting the ciphertext column addressed to it. Missing-slot
fillers (quirk 3) are made deterministic: absent Paillier slots become
zero keys as in the reference, but absent dlog slots raise instead of
generating random garbage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..backend import get_backend
from ..config import ProtocolConfig, DEFAULT_CONFIG
from ..core import paillier, vss
from ..core.paillier import EncryptionKey
from ..core.secp256k1 import GENERATOR, Scalar
from ..errors import (
    BroadcastedPublicKeyError,
    NewPartyUnassignedIndexError,
    PublicShareValidationError,
    RingPedersenProofValidation,
)
from ..proofs.composite_dlog import CompositeDLogProof, DLogStatement
from ..proofs.correct_key import NiCorrectKeyProof
from ..proofs.ring_pedersen import RingPedersenProof, RingPedersenStatement
from .local_key import LocalKey, PaillierKeyPair, SharedKeys


@dataclass
class JoinMessage:
    """Field set mirrors `src/add_party_message.rs:36-45`."""

    ek: EncryptionKey
    dk_correctness_proof: NiCorrectKeyProof
    party_index: Optional[int]
    dlog_statement: DLogStatement
    composite_dlog_proof_base_h1: CompositeDLogProof
    composite_dlog_proof_base_h2: CompositeDLogProof
    ring_pedersen_statement: RingPedersenStatement
    ring_pedersen_proof: RingPedersenProof

    # ------------------------------------------------------------------
    @staticmethod
    def distribute(
        config: ProtocolConfig = DEFAULT_CONFIG,
    ) -> tuple["JoinMessage", PaillierKeyPair]:
        """New-party sender path (reference :101-124): three independent
        modulus generations (Paillier pair, h1/h2/N-tilde, ring-Pedersen).
        The ring-Pedersen and correct-key provers' modexp columns take the
        configured batch powm, as `RefreshMessage.distribute_batch`'s do
        (the card on the cuda backend)."""
        from ..backend.powm import get_batch_powm
        from .keygen import create_paillier_keypair, generate_dlog_statement_proofs

        powm = get_batch_powm(config)
        pair = create_paillier_keypair(config)
        dlog_statement, proof_h1, proof_h2 = generate_dlog_statement_proofs(config)
        rp_statement, rp_witness = RingPedersenStatement.generate(config)
        rp_proof = RingPedersenProof.prove(
            rp_witness, rp_statement, config.m_security, powm=powm,
            hash_alg=config.hash_alg,
        )

        msg = JoinMessage(
            ek=pair.ek,
            dk_correctness_proof=NiCorrectKeyProof.proof(
                pair.dk, rounds=config.correct_key_rounds, powm=powm,
                hash_alg=config.hash_alg,
            ),
            party_index=None,
            dlog_statement=dlog_statement,
            composite_dlog_proof_base_h1=proof_h1,
            composite_dlog_proof_base_h2=proof_h2,
            ring_pedersen_statement=rp_statement,
            ring_pedersen_proof=rp_proof,
        )
        return msg, pair

    def set_party_index(self, new_party_index: int) -> None:
        self.party_index = new_party_index

    def get_party_index(self) -> int:
        if self.party_index is None:
            raise NewPartyUnassignedIndexError()
        return self.party_index

    # ------------------------------------------------------------------
    def collect(
        self,
        refresh_messages: Sequence,
        paillier_key: PaillierKeyPair,
        join_messages: Sequence["JoinMessage"],
        t: int,
        n: int,
        config: ProtocolConfig = DEFAULT_CONFIG,
    ) -> LocalKey:
        """New-party receiver path: derive the first LocalKey
        (reference :136-294)."""
        from .refresh import RefreshMessage, _ec_device, combine_committed_points

        backend = get_backend(config)
        RefreshMessage.validate_collect(refresh_messages, t, n, config)

        rp_items = [
            (m.ring_pedersen_proof, m.ring_pedersen_statement) for m in refresh_messages
        ] + [(j.ring_pedersen_proof, j.ring_pedersen_statement) for j in join_messages]
        rp_verdicts = backend.verify_ring_pedersen(rp_items, config.m_security)
        for k, msg in enumerate(refresh_messages):
            if not rp_verdicts[k]:
                raise RingPedersenProofValidation(party_index=msg.party_index)
        for k, join in enumerate(join_messages):
            if not rp_verdicts[len(refresh_messages) + k]:
                raise RingPedersenProofValidation(
                    party_index=join.party_index if join.party_index is not None else -1
                )

        party_index = self.get_party_index()
        for join in join_messages:
            join.get_party_index()

        parameters = vss.ShamirSecretSharing(threshold=t, share_count=n)
        cipher_sum, li_vec = RefreshMessage.get_ciphertext_sum(
            refresh_messages, party_index, parameters, paillier_key.ek
        )
        # same Lagrange-weight hardening as refresh collect: the
        # interpolated Feldman constant terms must re-derive the group
        # key every sender broadcast (all-equal gated below)
        if (
            RefreshMessage.interpolate_constant_term(refresh_messages, li_vec, t)
            != refresh_messages[0].public_key
        ):
            raise PublicShareValidationError()
        new_share = paillier.decrypt(paillier_key.dk, paillier_key.ek, cipher_sum)
        new_share_fe = Scalar.from_int(new_share)

        keys_linear = SharedKeys(x_i=new_share_fe, y=GENERATOR * new_share_fe)

        pk_vec = combine_committed_points(
            refresh_messages, li_vec, t, n, _ec_device(config)
        )

        # same consistency gate as refresh collect: the decrypted share must
        # match the committed public share
        if keys_linear.y != pk_vec[party_index - 1]:
            raise PublicShareValidationError()

        available_eks = {m.party_index: m.ek for m in refresh_messages}
        available_eks[party_index] = paillier_key.ek
        for join in join_messages:
            available_eks[join.get_party_index()] = join.ek

        available_dlog = {m.party_index: m.dlog_statement for m in refresh_messages}
        available_dlog[party_index] = self.dlog_statement
        for join in join_messages:
            available_dlog[join.get_party_index()] = join.dlog_statement

        # absent Paillier slots become zero keys, as in the reference
        # (:244-255); absent dlog slots raise instead of random garbage
        # (conscious fix of quirk 3)
        paillier_key_vec: List[EncryptionKey] = []
        h1_h2_n_tilde_vec: List[DLogStatement] = []
        for party in range(1, n + 1):
            paillier_key_vec.append(
                available_eks.get(party, EncryptionKey(n=0, nn=0))
            )
            if party not in available_dlog:
                raise NewPartyUnassignedIndexError()
            h1_h2_n_tilde_vec.append(available_dlog[party])

        # all senders must broadcast the same public key (reference :270-274)
        for msg in refresh_messages:
            if msg.public_key != refresh_messages[0].public_key:
                raise BroadcastedPublicKeyError()

        own_scheme, _ = vss.share(t, n, new_share_fe)

        return LocalKey(
            paillier_dk=paillier_key.dk,
            pk_vec=pk_vec,
            keys_linear=keys_linear,
            paillier_key_vec=paillier_key_vec,
            y_sum_s=refresh_messages[0].public_key,
            h1_h2_n_tilde_vec=h1_h2_n_tilde_vec,
            vss_scheme=own_scheme,
            i=party_index,
            t=t,
            n=n,
        )
