"""In-process broadcast simulation, a reusable test fixture.

The reference models the broadcast channel as vectors pushed into
per-party buckets (`src/test.rs:238-334`); removal is exclusion from
broadcast. Same here, as a reusable object instead of test-local loops.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from ..config import ProtocolConfig, DEFAULT_CONFIG
from ..core.paillier import DecryptionKey
from .local_key import LocalKey
from .refresh import RefreshMessage


class BroadcastChannel:
    """Reliable broadcast with per-party delivery buckets and exclusion
    (used to model party removal, reference `src/test.rs:260-278`)."""

    def __init__(self, party_indices: Sequence[int]):
        self.buckets: Dict[int, List[RefreshMessage]] = {
            i: [] for i in party_indices
        }

    def broadcast(self, msg: RefreshMessage, exclude: Sequence[int] = ()) -> None:
        for party, bucket in self.buckets.items():
            if party in exclude:
                continue
            bucket.append(msg)

    def inbox(self, party_index: int) -> List[RefreshMessage]:
        return self.buckets[party_index]


def simulate_dkr(
    keys: List[LocalKey], config: ProtocolConfig = DEFAULT_CONFIG
) -> tuple[List[RefreshMessage], List[DecryptionKey]]:
    """Full refresh round: everyone distributes, everyone collects
    (reference `src/test.rs:311-334`)."""
    n = len(keys)
    results = RefreshMessage.distribute_batch(
        [(key.i, key) for key in keys], n, config
    )
    broadcast: List[RefreshMessage] = [m for m, _ in results]
    new_dks: List[DecryptionKey] = [dk for _, dk in results]
    for i, key in enumerate(keys):
        RefreshMessage.collect(broadcast, key, new_dks[i], (), config)
    return broadcast, new_dks


def simulate_dkr_removal(
    keys: List[LocalKey],
    remove_party_indices: Sequence[int],
    config: ProtocolConfig = DEFAULT_CONFIG,
) -> None:
    """Refresh with removal: removed parties are excluded from broadcast and
    must fail their own collect (reference `src/test.rs:238-309`).

    Reference-behavior quirk preserved deliberately: the reference's
    removal harness runs the survivors' `collect` on *clones* held in a
    side map (`src/test.rs:246,253` builds `party_key` from clones;
    `:286-298` mutates those clones), so the caller's keys are left at
    their pre-refresh values. This keeps later rounds consistent even
    though removed parties — which could not collect — rebroadcast from
    stale state. We mirror that observable behavior: survivors' collect is
    exercised (must succeed) on clones, removed parties' collect must
    fail, and the input keys emerge unrotated apart from the vss_scheme
    mutation done by distribute.
    """
    from ..errors import FsDkrError

    n = len(keys)
    channel = BroadcastChannel([k.i for k in keys])
    new_dks: Dict[int, DecryptionKey] = {}

    messages: List[RefreshMessage] = []
    for key in keys:
        msg, dk = RefreshMessage.distribute(key.i, key, n, config)
        new_dks[key.i] = dk
        messages.append(msg)

    for msg in messages:
        # a removed party doesn't list itself (reference :260-268)
        msg.remove_party_indices = [
            r for r in remove_party_indices if r != msg.party_index
        ]
        channel.broadcast(msg, exclude=msg.remove_party_indices)

    for r in remove_party_indices:
        assert len(channel.inbox(r)) == 1  # only its own message

    for key in keys:
        if key.i in remove_party_indices:
            continue
        # survivors must be able to collect — exercised on a clone
        # (reference discards the refreshed state, see docstring)
        RefreshMessage.collect(
            channel.inbox(key.i), key.clone(), new_dks[key.i], (), config
        )

    for r in remove_party_indices:
        key = next(k for k in keys if k.i == r)
        try:
            RefreshMessage.collect(channel.inbox(r), key.clone(), new_dks[r], (), config)
        except FsDkrError:
            continue
        raise AssertionError("removed party unexpectedly completed collect")
