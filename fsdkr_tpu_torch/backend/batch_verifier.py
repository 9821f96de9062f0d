"""Batch verification interface + host implementation.

Each method takes a list of proof instances (one per (sender, receiver)
pair or per sender) and returns one verdict per instance, in order.
Verdicts are never short-circuited: the caller maps failing rows back to
party indices for identifiable abort (reference error semantics,
`src/error.rs`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..config import ProtocolConfig
from ..core.paillier import EncryptionKey
from ..core.secp256k1 import Point
from ..core.vss import VerifiableSS
from ..errors import PDLwSlackProofError
from ..proofs.alice_range import AliceProof
from ..proofs.composite_dlog import CompositeDLogProof, DLogStatement
from ..proofs.correct_key import NiCorrectKeyProof
from ..proofs.pdl_slack import PDLwSlackProof, PDLwSlackStatement
from ..proofs.ring_pedersen import RingPedersenProof, RingPedersenStatement


class BatchVerifier:
    """Interface; see HostBatchVerifier for reference semantics."""

    def verify_pdl(
        self, items: Sequence[Tuple[PDLwSlackProof, PDLwSlackStatement]]
    ) -> List[Optional[Tuple[bool, bool, bool]]]:
        """Per item: None if valid, else the (u1, u2, u3) equation booleans."""
        raise NotImplementedError

    def verify_range(
        self, items: Sequence[Tuple[AliceProof, int, EncryptionKey, DLogStatement]]
    ) -> List[bool]:
        raise NotImplementedError

    def verify_pairs(self, pdl_items, range_items, session_spans=None):
        """Both families of the O(n^2) pair loop
        (`src/refresh_message.rs:330-350`). Default: two family calls;
        the device backend overrides to share one fused launch set.
        `session_spans` (session -> [lo, hi) row span of a fused
        multi-session batch) is advisory: these verdicts are per-row exact
        already, so it is ignored here."""
        return self.verify_pdl(pdl_items), self.verify_range(range_items)

    def verify_ring_pedersen(
        self, items: Sequence[Tuple[RingPedersenProof, RingPedersenStatement]], m_security: int
    ) -> List[bool]:
        raise NotImplementedError

    def verify_correct_key(
        self, items: Sequence[Tuple[NiCorrectKeyProof, EncryptionKey]], rounds: int
    ) -> List[bool]:
        raise NotImplementedError

    def verify_composite_dlog(
        self, items: Sequence[Tuple[CompositeDLogProof, DLogStatement]]
    ) -> List[bool]:
        raise NotImplementedError

    def validate_feldman(
        self, items: Sequence[Tuple[VerifiableSS, Point, int]]
    ) -> List[bool]:
        """Per item: scheme, public share point, 1-based evaluation index."""
        raise NotImplementedError


class HostBatchVerifier(BatchVerifier):
    def __init__(self, hash_alg: Optional[str] = None):
        # None -> the process-default digest (core.transcript); get_backend
        # binds the session's config.hash_alg here
        self._hash_alg = hash_alg

    def verify_pdl(self, items):
        out = []
        for proof, st in items:
            try:
                proof.verify(st, hash_alg=self._hash_alg)
                out.append(None)
            except PDLwSlackProofError as e:
                out.append((e.is_u1_eq, e.is_u2_eq, e.is_u3_eq))
        return out

    def verify_range(self, items):
        return [
            proof.verify(c, ek, dlog, hash_alg=self._hash_alg)
            for proof, c, ek, dlog in items
        ]

    def verify_ring_pedersen(self, items, m_security):
        out = []
        for proof, st in items:
            try:
                proof.verify(st, m_security, hash_alg=self._hash_alg)
                out.append(True)
            except Exception:
                out.append(False)
        return out

    def verify_correct_key(self, items, rounds):
        return [
            proof.verify(ek, rounds=rounds, hash_alg=self._hash_alg)
            for proof, ek in items
        ]

    def verify_composite_dlog(self, items):
        return [proof.verify(st, hash_alg=self._hash_alg) for proof, st in items]

    def validate_feldman(self, items):
        """Feldman share validation: one native Horner launch a commitment
        vector (native/ec.py), the rows sharing a scheme (every receiver
        slot of one message) staging its t+1 commitments once. A scheme
        whose indices the core cannot take is checked row by row with the
        Python points, as in the JAX package."""
        from ..native import ec as native_ec

        groups: dict = {}
        for row, (scheme, _, _) in enumerate(items):
            groups.setdefault(id(scheme), []).append(row)
        out = [False] * len(items)
        for rows in groups.values():
            scheme = items[rows[0]][0]
            commits = [None if c.infinity else (c.x, c.y) for c in scheme.commitments]
            evals = native_ec.horner_batch(commits, [items[row][2] for row in rows])
            if evals is None:  # outside the core's domain: the Python check
                for row in rows:
                    scheme, point, idx = items[row]
                    out[row] = scheme.validate_share_public(point, idx)
                continue
            for row, ev in zip(rows, evals):
                point = items[row][1]
                if ev is None:
                    out[row] = point.infinity
                else:
                    out[row] = (not point.infinity) and point.x == ev[0] and point.y == ev[1]
        return out


class TracedVerifier:
    """Wraps a backend with per-family phase timers and counters
    (`collect.{family}` phases, telemetry.spans). Not a BatchVerifier
    subclass: inherited methods would shadow the __getattr__ delegation."""

    def __init__(self, inner: BatchVerifier):
        self._inner = inner

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name.startswith(("verify_", "validate_")) and callable(attr):
            from ..telemetry.spans import phase

            def traced(items, *args, _attr=attr, _name=name, **kwargs):
                # multi-list calls (verify_pairs) count every list's rows
                rows = len(items) + sum(
                    len(a) for a in args if isinstance(a, (list, tuple))
                )
                with phase(f"collect.{_name}", items=rows):
                    return _attr(items, *args, **kwargs)

            return traced
        return attr


def get_backend(config: ProtocolConfig) -> TracedVerifier:
    """The configured verifier wrapped in a TracedVerifier (which quacks
    like a BatchVerifier by delegation), with the session's hash_alg bound
    into it (never installed process-wide)."""
    if config.backend == "host":
        return TracedVerifier(HostBatchVerifier(config.hash_alg))
    if config.backend == "cuda":
        from .cuda_verifier import CudaBatchVerifier

        return TracedVerifier(CudaBatchVerifier(config))
    raise ValueError(f"unknown backend {config.backend!r}")
