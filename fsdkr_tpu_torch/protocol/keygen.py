"""Distributed key generation producing valid `LocalKey`s.

Equivalent of the reference's test-only GG20 keygen simulation
(`src/test.rs:226-236` driving `multi-party-ecdsa` Keygen
state machines through `round-based::Simulation`). Here the DKG rounds are
executed directly in-process (SURVEY.md §4 rebuild implication iv): each
party Feldman-shares a random u_i, x_i = sum of received shares, the group
key is y = (sum u_i) * G — exactly the algebra the GG20 keygen state
machines settle on, without the message-routing scaffolding.

Also provides `generate_h1_h2_n_tilde` / `generate_dlog_statement_proofs`,
the setup used by the join path (`src/add_party_message.rs:50-92`).
"""

from __future__ import annotations

import secrets
from typing import List

from ..config import ProtocolConfig, DEFAULT_CONFIG
from ..core import intops, paillier, primes, vss
from ..core.secp256k1 import GENERATOR, Point, Scalar
from ..proofs.composite_dlog import CompositeDLogProof, DLogStatement
from .local_key import LocalKey, PaillierKeyPair, SharedKeys


def generate_h1_h2_n_tilde(
    config: ProtocolConfig = DEFAULT_CONFIG,
) -> tuple[int, int, int, int, int]:
    """Fresh (N_tilde, h1, h2, xhi, xhi_inv) with h2 = h1^xhi and the
    returned exponents negated mod phi so that h2 = h1^{-xhi_ret}
    (reference `src/add_party_message.rs:50-66`)."""
    n_tilde, p, q = primes.gen_modulus(config.paillier_bits)
    phi = (p - 1) * (q - 1)
    h1 = intops.sample_unit(n_tilde)
    while True:
        xhi = secrets.randbelow(phi)
        xhi_inv = intops.mod_inv(xhi, phi)
        if xhi_inv is not None:
            break
    h2 = intops.mod_pow(h1, xhi, n_tilde)
    return n_tilde, h1, h2, phi - xhi, phi - xhi_inv


def generate_dlog_statement_proofs(
    config: ProtocolConfig = DEFAULT_CONFIG,
) -> tuple[DLogStatement, CompositeDLogProof, CompositeDLogProof]:
    """DLogStatement + composite-dlog proofs in both base directions
    (reference `src/add_party_message.rs:69-92`)."""
    n_tilde, h1, h2, xhi, xhi_inv = generate_h1_h2_n_tilde(config)
    st_h1 = DLogStatement(N=n_tilde, g=h1, ni=h2)
    st_h2 = DLogStatement(N=n_tilde, g=h2, ni=h1)
    return (
        st_h1,
        CompositeDLogProof.prove(st_h1, xhi, config.hash_alg),
        CompositeDLogProof.prove(st_h2, xhi_inv, config.hash_alg),
    )


def create_paillier_keypair(config: ProtocolConfig = DEFAULT_CONFIG) -> PaillierKeyPair:
    ek, dk = paillier.keygen(config.paillier_bits)
    return PaillierKeyPair(ek=ek, dk=dk)


def simulate_keygen(
    t: int, n: int, config: ProtocolConfig = DEFAULT_CONFIG
) -> List[LocalKey]:
    """Run an in-process (t, n) DKG; returns one LocalKey per party."""
    if not (0 < t < n):
        raise ValueError("need 0 < t < n")

    # round 1-2: every party shares a random u_j
    contributions = [vss.share(t, n, Scalar.random()) for _ in range(n)]
    y = Point.identity()
    for scheme, _ in contributions:
        y = y + scheme.commitments[0]

    # party i's share: x_i = sum_j f_j(i)
    x = []
    for i in range(n):
        acc = Scalar.zero()
        for _, shares in contributions:
            acc = acc + shares[i]
        x.append(acc)
    pk_vec = [GENERATOR * x_i for x_i in x]

    # per-party auxiliary setup: Paillier pair + h1/h2/N_tilde
    paillier_pairs = [paillier.keygen(config.paillier_bits) for _ in range(n)]
    dlog_statements = []
    for _ in range(n):
        n_tilde, h1, h2, _, _ = generate_h1_h2_n_tilde(config)
        dlog_statements.append(DLogStatement(N=n_tilde, g=h1, ni=h2))

    keys = []
    for i in range(n):
        ek_i, dk_i = paillier_pairs[i]
        own_scheme, _ = vss.share(t, n, x[i])
        keys.append(
            LocalKey(
                paillier_dk=dk_i,
                pk_vec=list(pk_vec),
                keys_linear=SharedKeys(x_i=x[i], y=GENERATOR * x[i]),
                paillier_key_vec=[pp[0] for pp in paillier_pairs],
                y_sum_s=y,
                h1_h2_n_tilde_vec=list(dlog_statements),
                vss_scheme=own_scheme,
                i=i + 1,
                t=t,
                n=n,
            )
        )
    return keys
