"""Protocol layer: the refresh protocol itself (refresh, replace, join,
streaming collect, the JSON wire format) plus the GG20-compatible host application surface the reference borrows
from `multi-party-ecdsa` (LocalKey, simulated keygen, threshold signing).
"""

from .local_key import LocalKey, SharedKeys, PaillierKeyPair
from .refresh import RefreshMessage
from .join import JoinMessage
from .keygen import simulate_keygen, generate_h1_h2_n_tilde, generate_dlog_statement_proofs
from .signing import simulate_offline_stage, simulate_signing, ecdsa_verify
from .simulation import BroadcastChannel, simulate_dkr, simulate_dkr_removal
from .streaming import StreamingCollect, finalize_streams, stream_rows
from .serialization import (
    refresh_message_to_json,
    refresh_message_from_json,
    join_message_to_json,
    join_message_from_json,
    local_key_to_json,
    local_key_from_json,
)

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
    "StreamingCollect",
    "finalize_streams",
    "stream_rows",
    "refresh_message_to_json",
    "refresh_message_from_json",
    "join_message_to_json",
    "join_message_from_json",
    "local_key_to_json",
    "local_key_from_json",
]
