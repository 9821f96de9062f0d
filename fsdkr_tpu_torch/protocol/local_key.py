"""The central mutable state object: a party's share of a GG20 key.

Equivalent of `multi-party-ecdsa`'s `LocalKey<E>` with the exact field set
the reference reads/rewrites (`src/add_party_message.rs:280-291`,
mutation sites `src/refresh_message.rs:64,315-317,394,436,446-464`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..core.paillier import DecryptionKey, EncryptionKey
from ..core.secp256k1 import Point, Scalar
from ..core.vss import VerifiableSS
from ..proofs.composite_dlog import DLogStatement


@dataclass
class SharedKeys:
    """`SharedKeys{x_i, y}`: the linear share and its public point
    (reference `src/add_party_message.rs:199-202`)."""

    x_i: Scalar
    y: Point


@dataclass
class PaillierKeyPair:
    """A fresh Paillier pair as produced by `Keys::create`
    (reference `src/add_party_message.rs:102`)."""

    ek: EncryptionKey
    dk: DecryptionKey


@dataclass
class LocalKey:
    """Field-for-field equivalent of the reference's `LocalKey`:

    - paillier_dk: this party's Paillier secret key
    - pk_vec: per-party public shares X_j = x_j * G (1-based order)
    - keys_linear: own share x_i and y = x_i * G
    - paillier_key_vec: per-party Paillier public keys
    - y_sum_s: the unchanged group public key y
    - h1_h2_n_tilde_vec: per-party ring-Pedersen / dlog parameters
    - vss_scheme: this party's most recent Feldman scheme
    - i: own party index (1-based), t: threshold, n: committee size
    """

    paillier_dk: DecryptionKey
    pk_vec: List[Point]
    keys_linear: SharedKeys
    paillier_key_vec: List[EncryptionKey]
    y_sum_s: Point
    h1_h2_n_tilde_vec: List[DLogStatement]
    vss_scheme: VerifiableSS
    i: int
    t: int
    n: int

    def clone(self) -> "LocalKey":
        import copy

        return copy.deepcopy(self)

    def public_key(self) -> Point:
        return self.y_sum_s
