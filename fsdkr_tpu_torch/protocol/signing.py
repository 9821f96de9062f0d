"""GG20-compatible threshold ECDSA signing harness.

Equivalent of the reference's test-only use of `multi-party-ecdsa`'s
`OfflineStage` / `SignManual` (`src/test.rs:336-382`): enough of GG20's
signing algebra to prove that refreshed `LocalKey`s still sign together
under *different* quorums — the property the sign→rotate→sign scenarios
assert. Host algebra (Paillier MtA and scalar arithmetic), not a path for
the card.

The offline stage runs GG20's actual share-conversion algebra in-process:
- additive reshare: w_i = lambda_i(S) * x_i so that sum w_i = x
- nonce/blinding: each party picks k_i, gamma_i
- the cross terms of k*gamma and k*w are computed by real Paillier MtA
  (ciphertext mul/add under the receiver's key; the ZK range proofs
  that wrap MtA in GG20 are omitted in this honest-party simulation, as
  the reference's Simulation also elides network adversaries)
- delta = k*gamma is revealed; R = (sum Gamma_i) * delta^{-1} = G * k^{-1}
- partial sigs: s_i = m*k_i + r*sigma_i; s = sum s_i

The final (r, s) verifies under vanilla ECDSA against y_sum_s.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass
from typing import List, Sequence

from ..core import paillier, vss
from ..core.secp256k1 import GENERATOR, N as CURVE_ORDER, Point, Scalar
from .local_key import LocalKey


@dataclass
class CompletedOfflineStage:
    """Per-party output of the offline stage (GG20's CompletedOfflineStage
    role: everything needed to sign any message with one add)."""

    party_index: int  # 1-based position inside the quorum
    r: Scalar  # R.x mod q, shared
    R: Point
    k_i: Scalar
    sigma_i: Scalar  # additive share of k*x
    public_key: Point

    # PartialSignature equivalent
    def partial_sig(self, message: Scalar) -> Scalar:
        return message * self.k_i + self.r * self.sigma_i


@dataclass
class PartialSignature:
    value: Scalar


def message_scalar(message: bytes) -> Scalar:
    return Scalar.from_int(int.from_bytes(hashlib.sha256(message).digest(), "big"))


def _mta(ek_a, dk_a, a: Scalar, b: Scalar) -> tuple[Scalar, Scalar]:
    """One MtA exchange: Alice holds a (and the Paillier key), Bob holds b.
    Returns additive shares (alpha for Alice, beta for Bob) of a*b mod q."""
    enc_a = paillier.encrypt(ek_a, a.to_int())
    # Bob: Enc(a)*b + Enc(beta_prim); beta_prim stat-hides a*b (< q^2 << n/2)
    beta_prim = secrets.randbelow(ek_a.n >> 1)
    c = paillier.add(
        ek_a,
        paillier.mul(ek_a, enc_a, b.to_int()),
        paillier.encrypt(ek_a, beta_prim),
    )
    alpha = Scalar.from_int(paillier.decrypt(dk_a, ek_a, c))
    beta = Scalar.from_int(-beta_prim)
    return alpha, beta


def simulate_offline_stage(
    local_keys: Sequence[LocalKey], s_l: Sequence[int]
) -> List[CompletedOfflineStage]:
    """Run the offline stage for quorum `s_l` (1-based key indices, as in
    the reference's OfflineStage::new, `src/test.rs:343-352`)."""
    quorum = [local_keys[i - 1] for i in s_l]
    m = len(quorum)
    if m < quorum[0].t + 1:
        raise ValueError("quorum smaller than threshold+1")

    # additive reshare: w_i = lambda_i * x_i over 0-based indices s_l-1
    zero_based = [i - 1 for i in s_l]
    params = vss.ShamirSecretSharing(quorum[0].t, quorum[0].n)
    w = [
        vss.map_share_to_new_params(params, zero_based[j], zero_based)
        * quorum[j].keys_linear.x_i
        for j in range(m)
    ]

    k = [Scalar.random() for _ in range(m)]
    gamma = [Scalar.random() for _ in range(m)]

    # delta_i / sigma_i accumulate own product + MtA cross-term shares
    delta = [k[i] * gamma[i] for i in range(m)]
    sigma = [k[i] * w[i] for i in range(m)]
    for i in range(m):
        for j in range(m):
            if i == j:
                continue
            ek_i = quorum[i].paillier_key_vec[quorum[i].i - 1]
            dk_i = quorum[i].paillier_dk
            alpha, beta = _mta(ek_i, dk_i, k[i], gamma[j])
            delta[i] = delta[i] + alpha
            delta[j] = delta[j] + beta
            mu, nu = _mta(ek_i, dk_i, k[i], w[j])  # MtAwc in GG20
            sigma[i] = sigma[i] + mu
            sigma[j] = sigma[j] + nu

    delta_sum = Scalar.zero()
    for d in delta:
        delta_sum = delta_sum + d

    Gamma = Point.identity()
    for g in gamma:
        Gamma = Gamma + GENERATOR * g
    R = Gamma * delta_sum.invert()
    r = Scalar.from_int(R.x_coord())

    return [
        CompletedOfflineStage(
            party_index=i + 1,
            r=r,
            R=R,
            k_i=k[i],
            sigma_i=sigma[i],
            public_key=quorum[i].y_sum_s,
        )
        for i in range(m)
    ]


class SignManual:
    """Mirror of the reference's SignManual two-step API
    (`src/test.rs:357-382`): construct with the message to get a partial
    signature, then `complete` with the others' partials."""

    def __init__(self, message: Scalar, offline: CompletedOfflineStage):
        self.message = message
        self.offline = offline
        self.local_sig = PartialSignature(value=offline.partial_sig(message))

    def complete(self, others: Sequence[PartialSignature]) -> tuple[Scalar, Scalar]:
        s = self.local_sig.value
        for p in others:
            s = s + p.value
        r = self.offline.r
        # low-s normalization, standard ECDSA malleability rule
        if s.to_int() > CURVE_ORDER // 2:
            s = Scalar.from_int(CURVE_ORDER - s.to_int())
        if not r or not s:
            raise ValueError("degenerate signature")
        return r, s


def ecdsa_verify(signature: tuple[Scalar, Scalar], public_key: Point, message: Scalar) -> bool:
    """Vanilla ECDSA verification (the reference delegates to
    gg_2020::party_i::verify, `src/test.rs:381`)."""
    r, s = signature
    if not r or not s:
        return False
    s_inv = s.invert()
    u1 = message * s_inv
    u2 = r * s_inv
    point = GENERATOR * u1 + public_key * u2
    if point == Point.identity():
        return False
    return Scalar.from_int(point.x_coord()).v == r.v


def simulate_signing(offline: Sequence[CompletedOfflineStage], message: bytes) -> None:
    """Every quorum member completes the signature from the others'
    partials; all results must verify (reference `src/test.rs:357-382`)."""
    msg = message_scalar(message)
    pk = offline[0].public_key
    parties = [SignManual(msg, o) for o in offline]
    partials = [p.local_sig for p in parties]
    for i, p in enumerate(parties):
        others = partials[:i] + partials[i + 1 :]
        sig = p.complete(others)
        assert ecdsa_verify(sig, pk, msg), "threshold signature failed to verify"
