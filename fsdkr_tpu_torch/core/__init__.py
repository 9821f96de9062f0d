"""Host-side cryptographic core: bigint helpers, primes, transcripts,
secp256k1, Paillier and Feldman VSS over CPython ints — the oracle the
batched device columns are held against.
"""

from . import intops, primes, transcript, secp256k1, paillier, vss

__all__ = ["intops", "primes", "transcript", "secp256k1", "paillier", "vss"]
