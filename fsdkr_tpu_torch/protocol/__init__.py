"""Protocol layer: the refresh protocol itself (refresh, replace, join)
plus the GG20-compatible host application surface the reference borrows
from `multi-party-ecdsa` (LocalKey, simulated keygen, threshold signing).
"""

from .local_key import LocalKey, SharedKeys, PaillierKeyPair
from .refresh import RefreshMessage
from .join import JoinMessage
from .keygen import simulate_keygen, generate_h1_h2_n_tilde, generate_dlog_statement_proofs
from .signing import simulate_offline_stage, simulate_signing, ecdsa_verify
from .simulation import BroadcastChannel, simulate_dkr, simulate_dkr_removal

__all__ = [
    "LocalKey",
    "SharedKeys",
    "PaillierKeyPair",
    "RefreshMessage",
    "JoinMessage",
    "simulate_keygen",
    "generate_h1_h2_n_tilde",
    "generate_dlog_statement_proofs",
    "simulate_offline_stage",
    "simulate_signing",
    "ecdsa_verify",
    "BroadcastChannel",
    "simulate_dkr",
    "simulate_dkr_removal",
]
