"""Protocol layer: the refresh protocol itself plus the GG20-compatible
key surface the reference borrows from `multi-party-ecdsa` (LocalKey,
simulated keygen).
"""

from .local_key import LocalKey, SharedKeys, PaillierKeyPair
from .refresh import RefreshMessage
from .keygen import simulate_keygen, generate_h1_h2_n_tilde

__all__ = [
    "LocalKey",
    "SharedKeys",
    "PaillierKeyPair",
    "RefreshMessage",
    "simulate_keygen",
    "generate_h1_h2_n_tilde",
]
