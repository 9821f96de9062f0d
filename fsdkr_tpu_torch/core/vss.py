"""Feldman verifiable secret sharing over secp256k1.

Capability surface of curv's `VerifiableSS` as consumed by the reference
(SURVEY.md §2b): `share(t, n, secret)`, `validate_share_public`,
`map_share_to_new_params` (Lagrange basis at 0), `reconstruct` (usage
`src/refresh_message.rs:62,180-183,211-219`,
`src/test.rs:53-65`).

Conventions match curv: party i (1-based) holds the polynomial evaluation
f(i); `map_share_to_new_params(params, index, s)` takes 0-based indices and
evaluates the Lagrange basis of point index+1 at 0 over the points
{ j+1 : j in s }.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from .secp256k1 import GENERATOR, N, Point, Scalar

__all__ = ["ShamirSecretSharing", "VerifiableSS", "share", "map_share_to_new_params", "reconstruct"]


@dataclass(frozen=True)
class ShamirSecretSharing:
    """(t, n) parameters: degree-t polynomial, n shares; t+1 reconstruct."""

    threshold: int
    share_count: int


@dataclass
class VerifiableSS:
    """A Feldman VSS instance: parameters + commitments A_k = a_k * G to the
    t+1 polynomial coefficients.

    `delegate_cert` is the optional MSM-delegation certificate that the
    JAX package's dealers attach under FSDKR_DELEGATE: one broadcast-public
    point R = (sum_u rho_u f(u)) * G. The port carries it on the wire and
    emits and checks none: its verifiers validate every share by the
    Feldman MSM, which gives the same verdicts. None (the default) omits
    the key from the wire encoding."""

    parameters: ShamirSecretSharing
    commitments: List[Point] = field(default_factory=list)
    delegate_cert: Optional[Point] = None

    def validate_share_public(self, public_share: Point, index: int) -> bool:
        """Check sum_k A_k * index^k == public_share
        (reference check site `src/refresh_message.rs:180-183`).

        Horner evaluation: the scalar `index` is tiny (<= share_count), so
        this is t small-scalar muls — the same shape the TPU batch uses.
        """
        acc = Point.identity()
        for a_k in reversed(self.commitments):
            acc = acc * index + a_k
        return acc == public_share

    def reconstruct(self, indices: Sequence[int], shares: Sequence[Scalar]) -> Scalar:
        """Lagrange-interpolate f(0) from shares at 0-based `indices`."""
        if len(indices) != len(shares):
            raise ValueError("indices/shares length mismatch")
        if len(set(indices)) != len(indices):
            raise ValueError("duplicate share indices")
        if len(shares) < self.parameters.threshold + 1:
            raise ValueError(
                f"need at least {self.parameters.threshold + 1} shares, got {len(shares)}"
            )
        acc = Scalar.zero()
        for idx, sh in zip(indices, shares):
            lam = map_share_to_new_params(self.parameters, idx, indices)
            acc = acc + lam * sh
        return acc


def sample_poly(t: int, n: int, secret: Scalar) -> tuple[List[Scalar], List[Scalar]]:
    """Sample a degree-t polynomial with f(0)=secret; return (coefficients,
    shares f(1..n)). Commitment to the coefficients is a separate step so
    many senders' coefficient columns can be committed together."""
    coeffs = [secret] + [Scalar(secrets.randbelow(N)) for _ in range(t)]
    shares = []
    for i in range(1, n + 1):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * i + c.v) % N
        shares.append(Scalar(acc))
    return coeffs, shares


def share(t: int, n: int, secret: Scalar) -> tuple[VerifiableSS, List[Scalar]]:
    """Sample a degree-t polynomial with f(0)=secret; return commitments to
    its coefficients and the n shares f(1..n)
    (reference call site `src/refresh_message.rs:62`)."""
    coeffs, shares = sample_poly(t, n, secret)
    commitments = [GENERATOR * c for c in coeffs]
    return VerifiableSS(ShamirSecretSharing(t, n), commitments), shares


def map_share_to_new_params(
    params: ShamirSecretSharing, index: int, s: Sequence[int]
) -> Scalar:
    """Lagrange basis coefficient of point index+1 evaluated at 0 over the
    point set { j+1 : j in s } (curv semantics; reference call site
    `src/refresh_message.rs:211-219`)."""
    xi = index + 1
    num, den = 1, 1
    for j in s:
        xj = j + 1
        if xj == xi:
            continue
        num = (num * xj) % N
        den = (den * (xj - xi)) % N
    return Scalar(num * pow(den, -1, N))


def reconstruct(
    params: ShamirSecretSharing, indices: Sequence[int], shares: Sequence[Scalar]
) -> Scalar:
    return VerifiableSS(params).reconstruct(indices, shares)
