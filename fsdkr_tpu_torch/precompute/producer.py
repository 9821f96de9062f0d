"""Producers for the precompute pools: the offline constructors and
`prefill`, the one way to fill the pools (an own copy of the constructors
and the committee bookkeeping of fsdkr_tpu/precompute/producer.py; the
pool store lives in `pools.py`).

Production rides the same batch engines as the inline path: the
Paillier and mod-N~ columns take the config's modexp
(`backend.powm.get_batch_powm`: the device's, on the cuda backend), the
key material the native prime pipeline and the provers' engines. The
JAX package sends its producer's columns to the host engines, since its
TPU is busy verifying; the values are the same on either engine.

The pools are opt-in. `prefill(local_key, new_n, senders, config)` fills
one committee's pools and records the committee under its owner
(`committee_owner`: its mod-N~ moduli, public and stable across
refreshes). `distribute_batch` takes the pooled branch only for a
recorded committee (`claim`), and wipes what that committee's
per-receiver pools have left once it has taken from them (`release`):
their keys rotate with the epoch. A committee never prefilled
distributes inline and touches no pool. `replace` wipes the pools of the
layout it changes (`invalidate_owner`). The key-material pool is keyed
by config parameters alone and shared by every committee of that config.

The JAX package's background producer thread, its target registry with
its lifetimes, and the kicks that wake the thread are not ported: their
caller is the serving layer, which the port does not have yet.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from . import pools

__all__ = [
    "produce_enc",
    "produce_keys",
    "produce_for",
    "committee_owner",
    "committee_targets",
    "prefill",
    "claim",
    "release",
    "invalidate_owner",
    "clear_committees",
]


# ---------------------------------------------------------------------------
# per-kind constructors


def produce_enc(n: int, count: int, powm=None) -> List[tuple]:
    """`count` Paillier randomizer entries (r, r^n mod n^2) for receiver
    modulus n — r drawn exactly like paillier.sample_randomness (the
    seeded-parity contract), the power through `powm` (host pow when
    omitted)."""
    from ..core import intops

    if powm is None:
        from ..backend.powm import host_powm as powm
    rs = [intops.sample_unit(n) for _ in range(count)]
    rn = powm(rs, [n] * count, [n * n] * count)
    return list(zip(rs, rn))


def produce_keys(config, count: int) -> List[tuple]:
    """`count` complete key-material bundles (ek, dk, NiCorrectKeyProof,
    RingPedersenStatement, RingPedersenProof) for `config`'s pool key —
    the exact call sequence of distribute_batch's four key phases, so
    seeded runs produce identical material. Ring-Pedersen witnesses are
    dropped as soon as their proofs exist (the pooled bundle never
    carries phi/lambda)."""
    from ..backend.powm import get_batch_powm
    from ..core import paillier
    from ..proofs.correct_key import NiCorrectKeyProof
    from ..proofs.ring_pedersen import RingPedersenProof, RingPedersenStatement

    powm = get_batch_powm(config)
    ek_dk = paillier.keygen_batch(config.paillier_bits, count)
    rp = RingPedersenStatement.generate_batch(count, config)
    ck_proofs = NiCorrectKeyProof.proof_batch(
        [dk for _, dk in ek_dk], rounds=config.correct_key_rounds,
        powm=powm, hash_alg=config.hash_alg,
    )
    rp_proofs = RingPedersenProof.prove_batch(
        [w for _, w in rp], [st for st, _ in rp], config.m_security,
        powm, config.hash_alg,
    )
    out = [
        (ek, dk, ck, st_w[0], rp_p)
        for (ek, dk), ck, st_w, rp_p in zip(ek_dk, ck_proofs, rp, rp_proofs)
    ]
    rp.clear()  # drop the ring-Pedersen witnesses (phi/lambda) now
    return out


def produce_for(kind: str, key, count: int, config) -> int:
    """Produce and pool up to `count` entries of (kind, key) with
    `config`'s engines; returns how many the pool absorbed. Every value
    production needs is in the (public) pool key, the device in
    `config`."""
    if count <= 0:
        return 0
    from ..backend.powm import get_batch_powm

    if kind == "enc":
        entries = produce_enc(key, count, get_batch_powm(config))
    elif kind == "pdl":
        from ..proofs.pdl_slack import PDLwSlackProof

        h1, h2, nt, n = key
        entries = PDLwSlackProof.produce_stage1(
            h1, h2, nt, n, count, get_batch_powm(config)
        )
    elif kind == "alice":
        from ..proofs.alice_range import AliceProof

        h1, h2, nt, n = key
        entries = AliceProof.produce_stage1(
            h1, h2, nt, n, count, get_batch_powm(config)
        )
    elif kind == "keys":
        if key != config.key_material_pool_key:
            raise ValueError("key-material pool key does not match the config")
        entries = produce_keys(config, count)
    else:
        raise ValueError(f"unknown pool kind {kind!r}")
    return sum(1 for e in entries if pools.put(kind, key, e))


# ---------------------------------------------------------------------------
# prefilled committees

# owner -> the (kind, key) of the committee's per-receiver pools, as
# `prefill` filled them
_COMMITTEES: Dict[tuple, List[Tuple[str, object]]] = {}
_LOCK = threading.Lock()


def committee_owner(dlog_statements) -> tuple:
    """Stable committee fingerprint: the tuple of the committee's mod-N~
    moduli in slot order (public, stable across refreshes, changed only
    by churn)."""
    return ("committee-ntilde",) + tuple(d.N for d in dlog_statements)


def committee_targets(local_key, new_n: int, senders: int, config) -> list:
    """[(kind, key, want)] of one committee: `senders` entries per
    receiver pool (every sender consumes one entry per receiver per
    epoch) and `senders` key bundles. The ("keys", ...) target is LAST."""
    out = []
    for i in range(new_n):
        ek = local_key.paillier_key_vec[i]
        d = local_key.h1_h2_n_tilde_vec[i]
        env = (d.g, d.ni, d.N, ek.n)
        out.append(("enc", ek.n, senders))
        out.append(("pdl", env, senders))
        out.append(("alice", env, senders))
    out.append(("keys", config.key_material_pool_key, senders))
    return out


def prefill(local_key, new_n: int, senders: int, config) -> int:
    """Synchronous offline fill: bring every pool of this committee up to
    one epoch of depth with `config`'s engines and record the committee,
    so its next distribute takes the pooled branch. Returns the number
    of entries produced."""
    targets = committee_targets(local_key, new_n, senders, config)
    owner = committee_owner(local_key.h1_h2_n_tilde_vec[:new_n])
    with _LOCK:
        _COMMITTEES[owner] = [(kind, key) for kind, key, _ in targets[:-1]]
    store = pools.get_store()
    produced = 0
    for kind, key, want in targets:
        room = store.room(kind, key, want)
        if room > 0:
            produced += produce_for(kind, key, room, config)
    return produced


def claim(owner) -> Optional[List[Tuple[str, object]]]:
    """The per-receiver pool keys `prefill` recorded for `owner`, taken
    off the record; None when the committee was not prefilled (its
    distribute is inline)."""
    with _LOCK:
        return _COMMITTEES.pop(owner, None)


def release(keys) -> None:
    """Wipe what the pools of `keys` have left: a distribute has taken
    its epoch's entries, and the receivers' keys rotate at its end."""
    store = pools.get_store()
    for kind, key in keys:
        store.drop(kind, key)


def invalidate_owner(owner) -> int:
    """Forget `owner`'s committee and wipe its per-receiver pools — the
    churn entry point (replace re-keys the committee, so the old layout's
    pooled secrets can never be consumed). Returns the number of pools
    wiped."""
    keys = claim(owner)
    if keys is None:
        return 0
    release(keys)
    return len(keys)


def clear_committees() -> None:
    with _LOCK:
        _COMMITTEES.clear()
