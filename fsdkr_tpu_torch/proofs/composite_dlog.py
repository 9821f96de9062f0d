"""Composite discrete-log proof over Z_N-tilde^*.

Equivalent of zk-paillier's `DLogStatement` / `CompositeDLogProof`
(consumed by the reference at `src/add_party_message.rs:84-85`
and verified in both base directions at `src/refresh_message.rs:415-425`).

Statement (N, g, ni) with secret x such that ni = g^{-x} mod N
(the join path supplies x = phi - xhi where ni = g^{xhi},
`src/add_party_message.rs:62-64`). Schnorr-style sigma protocol made
non-interactive via Fiat-Shamir:

    prove:  r <- [0, N * 2^STAT_BITS);  C = g^r mod N
            e = H(C, g, N, ni);         y = r + e*x   (over the integers)
    verify: g^y * ni^e == C  (mod N)
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..core import intops
from ..core.transcript import Transcript

__all__ = ["DLogStatement", "CompositeDLogProof", "STAT_BITS"]

# statistical hiding slack for the integer response y = r + e*x
STAT_BITS = 256 + 128

_DOMAIN = b"fsdkr/composite-dlog/v1"


@dataclass(frozen=True)
class DLogStatement:
    """(N, g, ni): field names mirror the reference's `DLogStatement`
    shape (`src/add_party_message.rs:72-82`); in protocol
    use g = h1, ni = h2, N = N_tilde."""

    N: int
    g: int
    ni: int


@dataclass(frozen=True)
class CompositeDLogProof:
    x_commit: int  # C = g^r mod N
    y: int  # integer response

    @staticmethod
    def _challenge(
        x_commit: int, st: DLogStatement, hash_alg: str | None = None
    ) -> int:
        return (
            Transcript(_DOMAIN, algorithm=hash_alg)
            .chain_int(x_commit)
            .chain_int(st.g)
            .chain_int(st.N)
            .chain_int(st.ni)
            .result_challenge()
        )

    @staticmethod
    def prove(
        st: DLogStatement, secret_x: int, hash_alg: str | None = None
    ) -> "CompositeDLogProof":
        r = secrets.randbelow(st.N << STAT_BITS)
        x_commit = intops.mod_pow(st.g, r, st.N)
        e = CompositeDLogProof._challenge(x_commit, st, hash_alg)
        return CompositeDLogProof(x_commit=x_commit, y=r + e * secret_x)

    def verify(self, st: DLogStatement, hash_alg: str | None = None) -> bool:
        if not (0 < self.x_commit < st.N) or self.y < 0:
            return False
        if st.N <= 2 or st.g < 0 or st.ni < 0:  # fail closed, no crash
            return False
        e = CompositeDLogProof._challenge(self.x_commit, st, hash_alg)
        lhs = intops.mod_pow(st.g, self.y, st.N) * intops.mod_pow(st.ni, e, st.N) % st.N
        return lhs == self.x_commit
