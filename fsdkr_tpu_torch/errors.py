"""Error taxonomy, mirroring the reference's `FsDkrError`
(`src/error.rs:6-60`): every protocol failure names the
offending party where the reference does (identifiable abort).

The reference models errors as a serde-serializable enum; here each variant
is an exception subclass carrying the same fields, and `FsDkrError` is the
common base so callers can `except FsDkrError`.
"""

from __future__ import annotations


class FsDkrError(Exception):
    """Base class of all protocol errors (reference `FsDkrError`)."""


class PartiesThresholdViolation(FsDkrError):
    # reference: src/error.rs:9-14
    def __init__(self, threshold: int, refreshed_keys: int):
        self.threshold = threshold
        self.refreshed_keys = refreshed_keys
        super().__init__(
            f"Too many malicious parties detected! Threshold {threshold}, "
            f"number of refresh messages: {refreshed_keys}"
        )


class PublicShareValidationError(FsDkrError):
    # reference: src/error.rs:17
    def __init__(self) -> None:
        super().__init__("Shares did not pass verification.")


class SizeMismatchError(FsDkrError):
    # reference: src/error.rs:20-25
    def __init__(
        self,
        refresh_message_index: int,
        pdl_proof_len: int,
        points_committed_len: int,
        points_encrypted_len: int,
    ):
        self.refresh_message_index = refresh_message_index
        self.pdl_proof_len = pdl_proof_len
        self.points_committed_len = points_committed_len
        self.points_encrypted_len = points_encrypted_len
        super().__init__(
            f"Size mismatch for refresh message {refresh_message_index}: "
            f"pdl={pdl_proof_len} committed={points_committed_len} "
            f"encrypted={points_encrypted_len}"
        )


class PDLwSlackProofError(FsDkrError):
    """PDL-with-slack verification failure, with per-equation booleans
    (reference: src/error.rs:28-32). party_index is an identifiable-abort
    extension: the sender whose proof failed (None where unknown)."""

    def __init__(
        self,
        is_u1_eq: bool,
        is_u2_eq: bool,
        is_u3_eq: bool,
        party_index: "int | None" = None,
    ):
        self.is_u1_eq = is_u1_eq
        self.is_u2_eq = is_u2_eq
        self.is_u3_eq = is_u3_eq
        self.party_index = party_index
        who = "" if party_index is None else f" (party {party_index})"
        super().__init__(
            f"PDLwSlack proof verification failed: u1=={is_u1_eq}, "
            f"u2=={is_u2_eq}, u3=={is_u3_eq}{who}"
        )


class RingPedersenProofError(FsDkrError):
    # reference: src/error.rs:35
    def __init__(self) -> None:
        super().__init__("Ring Pedersen proof failed")


class RangeProofError(FsDkrError):
    # reference: src/error.rs:38
    def __init__(self, party_index: int):
        self.party_index = party_index
        super().__init__(f"Range proof failed for party: {party_index}")


class ModuliTooSmall(FsDkrError):
    # reference: src/error.rs:41-44
    def __init__(self, party_index: int, moduli_size: int):
        self.party_index = party_index
        self.moduli_size = moduli_size
        super().__init__(
            f"Paillier modulus of party {party_index} is {moduli_size} bits"
        )


class PaillierVerificationError(FsDkrError):
    # reference: src/error.rs:47
    def __init__(self, party_index: int):
        self.party_index = party_index
        super().__init__(f"Paillier correct-key proof failed for party {party_index}")


class NewPartyUnassignedIndexError(FsDkrError):
    # reference: src/error.rs:50
    def __init__(self) -> None:
        super().__init__("A new party did not receive a valid index.")


class BroadcastedPublicKeyError(FsDkrError):
    # reference: src/error.rs:53; party_index is an identifiable-abort
    # extension (None on the join path, where the culprit is unknowable)
    def __init__(self, party_index: "int | None" = None) -> None:
        self.party_index = party_index
        who = "" if party_index is None else f" (party {party_index})"
        super().__init__(
            f"Broadcast public keys are not all identical, aborting{who}"
        )


class DLogProofValidation(FsDkrError):
    # reference: src/error.rs:56
    def __init__(self, party_index: int):
        self.party_index = party_index
        super().__init__(f"Composite dlog proof failed for party {party_index}")


class RingPedersenProofValidation(FsDkrError):
    # reference: src/error.rs:59
    def __init__(self, party_index: int):
        self.party_index = party_index
        super().__init__(f"Ring Pedersen proof failed for party {party_index}")



class PrecomputeReuseError(FsDkrError):
    """A precompute pool entry was consumed twice (precompute/pools.py).
    Entries are strictly single-use: a Paillier randomizer or sigma
    first-message nonce that enters two transcripts collapses the
    zero-knowledge property (two challenges over one commitment reveal
    the witness), so the second take aborts hard instead of returning
    the wiped value."""

    def __init__(self):
        super().__init__("precompute pool entry consumed twice (single-use)")


class CrtFaultError(FsDkrError):
    """A secret-CRT modexp leg failed its Bellcore fault check
    (backend/crt.py): the recombined value is withheld entirely — a
    faulted CRT output would let gcd(output - truth, N) recover a prime
    factor of the prover's key, so the engine aborts hard instead of
    ever emitting it. No detail beyond the failure itself is exposed
    (the faulty residues stay inside the engine)."""

    def __init__(self):
        super().__init__("secret-CRT modexp failed its fault check")
