"""Fiat-Shamir transcript hashing (pluggable digest, SHA-256 default).

Provides the `curv` `Digest`/`DigestExt` capability the reference uses for
every NIZK challenge (`chain_bigint` / `result_bigint`, usage e.g.
`src/range_proofs.rs:150-157`,
`src/zk_pdl_with_slack.rs:87-95`, `src/ring_pedersen_proof.rs:96-105`).
The reference is generic over the digest (`HashChoice<H>`, a per-message
type parameter, `src/refresh_message.rs:31,46-47`); here the equivalent
knob is `ProtocolConfig.hash_alg`, threaded BY PARAMETER from the
protocol entry points through every proof's prove/verify into
`Transcript(algorithm=...)` / `challenge_bits(..., algorithm)` — so
sessions with different digests coexist and interleave in one process,
matching the reference's per-instance binding. Wider digests (sha512,
sha3_512, blake2b) raise the ring-Pedersen challenge capacity above 256
rounds.

`set_hash_algorithm` installs only the process-wide DEFAULT, used when a
proof is proven/verified standalone without an explicit algorithm (e.g.
ad-hoc after deserialization). Protocol-layer correctness never depends
on it.

This framework defines its own canonical encoding (SURVEY.md §7 step 2):
each chained value is hashed as a 4-byte big-endian length prefix followed
by its minimal big-endian magnitude bytes. The length prefix removes the
concatenation ambiguity of the reference's raw-byte chaining; prover and
verifier only ever need to agree with each other, not with the Rust wire
format.

Challenge-bit extraction replicates the reference's semantics
(`bitvec` Lsb0 over the digest bytes, `src/ring_pedersen_proof.rs:106,136`):
bit i of the challenge is bit (i % 8) of digest byte (i // 8), with the
digest taken as exactly 32 big-endian bytes.
"""

from __future__ import annotations

import hashlib

__all__ = [
    "Transcript",
    "hash_ints",
    "challenge_bits",
    "set_hash_algorithm",
    "get_hash_algorithm",
    "digest_bytes",
]

# name -> (constructor, digest size in bytes); blake2b at its native 64
_HASHES = {
    "sha256": (hashlib.sha256, 32),
    "sha384": (hashlib.sha384, 48),
    "sha512": (hashlib.sha512, 64),
    "sha3_256": (hashlib.sha3_256, 32),
    "sha3_512": (hashlib.sha3_512, 64),
    "blake2b": (hashlib.blake2b, 64),
}

_active = "sha256"


def set_hash_algorithm(name: str) -> None:
    """Install the process-wide transcript digest (ProtocolConfig.hash_alg)."""
    if name not in _HASHES:
        raise ValueError(f"unknown hash_alg {name!r}; choose from {sorted(_HASHES)}")
    global _active
    _active = name


def get_hash_algorithm() -> str:
    return _active


def digest_bytes(algorithm: str | None = None) -> int:
    name = algorithm or _active
    if name not in _HASHES:
        raise ValueError(f"unknown hash_alg {name!r}; choose from {sorted(_HASHES)}")
    return _HASHES[name][1]


class Transcript:
    """Transcript over a sequence of non-negative integers / bytes, using
    the active digest (default SHA-256)."""

    def __init__(self, domain: bytes = b"", algorithm: str | None = None):
        digest_bytes(algorithm)  # uniform ValueError on unknown names
        self._h = _HASHES[algorithm or _active][0]()
        if domain:
            self.chain_bytes(domain)

    def chain_bytes(self, b: bytes) -> "Transcript":
        self._h.update(len(b).to_bytes(4, "big"))
        self._h.update(b)
        return self

    def chain_int(self, x: int) -> "Transcript":
        if x < 0:
            raise ValueError("transcript integers must be non-negative")
        return self.chain_bytes(x.to_bytes((x.bit_length() + 7) // 8, "big"))

    def chain_point(self, point) -> "Transcript":
        """Chain a curve point via its compressed encoding, as the reference
        hashes `to_bytes(true)` (`src/zk_pdl_with_slack.rs:88-92`)."""
        return self.chain_bytes(point.to_bytes(compressed=True))

    def result_int(self) -> int:
        return int.from_bytes(self._h.digest(), "big")

    def result_challenge(self, bits: int = 256) -> int:
        """Digest truncated to a fixed challenge width. The integer-
        challenge sigma protocols (range, PDL, composite-dlog) size their
        blinding/range gates for a 256-bit challenge (q^3 slack,
        STAT_BITS); a wider configured digest must not widen e, or
        honest s1 = e*a + alpha overflows the verifier's range gate and
        integer responses lose statistical hiding. For sha256 this is
        the identity, preserving reference-exact challenges."""
        return self.result_int() & ((1 << bits) - 1)

    def result_bytes(self) -> bytes:
        return self._h.digest()


def hash_ints(values, domain: bytes = b"") -> int:
    t = Transcript(domain)
    for v in values:
        t.chain_int(v)
    return t.result_int()


def challenge_bits(e: int, m: int, algorithm: str | None = None) -> list[int]:
    """Extract m binary challenges from challenge integer e, Lsb0 order over
    the big-endian digest representation of the active hash
    (reference: `src/ring_pedersen_proof.rs:106`)."""
    size = digest_bytes(algorithm)
    if m > 8 * size:
        raise ValueError(
            f"{algorithm or _active} transcripts yield at most {8 * size} "
            "challenge bits"
        )
    raw = e.to_bytes(size, "big")
    return [(raw[i >> 3] >> (i & 7)) & 1 for i in range(m)]
