"""Producers for the precompute pools: the offline constructors, the
target registry, `prefill` and the background producer thread (an own
copy of fsdkr_tpu/precompute/producer.py; the pool store lives in
`pools.py`).

Production rides the same batch engines as the inline path: the
Paillier and mod-N~ columns take the config's modexp
(`backend.powm.get_batch_powm`: the device's, on the cuda backend), the
key material the native prime pipeline and the provers' engines. The
JAX package sends its producer's columns to the host engines, since its
TPU is busy verifying; the values are the same on either engine.

The pools are opt-in. A committee is recorded by registering its pool
TARGETS — (kind, public key, depth wanted) under an owner tag — in the
one registry below, by one of two callers: `prefill(local_key, new_n,
senders, config)` registers them under the committee's owner
(`committee_owner`: its mod-N~ moduli, public and stable across
refreshes; or the ambient `owner_scope`) and fills them now; the serving
layer's planner registers them under `serving.planner.serve_owner` with
`retarget_committee`, and the background producer fills them.
`distribute_batch` runs under the same owner (the service wraps it in
`owner_scope`) and takes the pooled branch only for a committee with
targets (`claim`: the per-receiver targets, taken off the registry so
the producer cannot refill pools the epoch is draining); it wipes what
those pools have left once it has taken from them (`release`): their
keys rotate with the epoch. A committee with no targets distributes
inline and touches no pool. `replace` and eviction wipe an owner's pools
(`invalidate_owner`). The key-material pool is keyed by config
parameters alone, shared by every committee of that config, and
registered under KEYS_POOL_OWNER.

The background producer (`kick`, `stop_background`) runs only where a
caller starts it: `serving.RefreshService.start()` and its kicks after
each distribute and each adopted epoch. The protocol layer kicks
nothing, and no environment variable starts it. Its launches count
apart from the callers' (`ops.tally.apart("producer")`).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..telemetry.spans import phase
from . import pools

__all__ = [
    "produce_enc",
    "produce_keys",
    "produce_for",
    "produce_batch",
    "committee_owner",
    "committee_targets",
    "KEYS_POOL_OWNER",
    "TARGET_TTL_S",
    "owner_scope",
    "current_registration_owner",
    "register_targets",
    "register_committee",
    "target_keys",
    "invalidate_targets",
    "invalidate_owner",
    "suspend_targets",
    "replace_targets",
    "retarget_committee",
    "clear_targets",
    "deficit_total",
    "prefill",
    "claim",
    "release",
    "kick",
    "stop_background",
    "producer_running",
    "producer_error",
]

# production step caps: one background step stays bounded (and stop()
# responsive) while still amortizing a launch over many rows
_PAIR_BATCH = 16  # entries a pool a step
_KEY_BATCH = 2  # key bundles a step


# ---------------------------------------------------------------------------
# per-kind constructors


def produce_enc(nv, powm=None) -> List[tuple]:
    """One Paillier randomizer entry (r, r^n mod n^2) per receiver modulus
    n of `nv` — r drawn exactly like paillier.sample_randomness (the
    seeded-parity contract), the powers through `powm` (host pow when
    omitted) in one column."""
    from ..core import intops

    if powm is None:
        from ..backend.powm import host_powm as powm
    rs = [intops.sample_unit(n) for n in nv]
    rn = powm(rs, list(nv), [n * n for n in nv])
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
    return produce_batch(kind, [(key, count)], config)


def produce_batch(kind: str, wants, config) -> int:
    """`produce_for` over many keys of one kind at once: wants =
    [(key, count)]. The keys' rows share one set of columns (one launch
    set where the JAX package makes one a key); each key's rows are
    sampled in order, so every pool receives what `produce_for` would
    have put there. Returns how many entries the pools absorbed. The
    batch is a span (`precompute.produce.<kind>`): on the background
    thread these are the producer's own track in the trace."""
    wants = [(key, c) for key, c in wants if c > 0]
    if not wants:
        return 0
    with phase(f"precompute.produce.{kind}", items=sum(c for _, c in wants)):
        return _produce_batch(kind, wants, config)


def _produce_batch(kind: str, wants, config) -> int:
    from ..backend.powm import get_batch_powm

    if kind == "keys":
        stored = 0
        for key, count in wants:
            if key != config.key_material_pool_key:
                raise ValueError("key-material pool key does not match the config")
            stored += sum(1 for e in produce_keys(config, count) if pools.put(kind, key, e))
        return stored
    powm = get_batch_powm(config)
    if kind == "enc":
        entries = produce_enc([n for n, c in wants for _ in range(c)], powm)
    elif kind in ("pdl", "alice"):
        if kind == "pdl":
            from ..proofs.pdl_slack import PDLwSlackProof as prover
        else:
            from ..proofs.alice_range import AliceProof as prover
        cols = [[k[j] for k, c in wants for _ in range(c)] for j in range(4)]
        entries = prover.produce_stage1(*cols, powm)
    else:
        raise ValueError(f"unknown pool kind {kind!r}")
    stored, pos = 0, 0
    for key, count in wants:
        stored += sum(1 for e in entries[pos : pos + count] if pools.put(kind, key, e))
        pos += count
    return stored


# ---------------------------------------------------------------------------
# the target registry

# (kind, key) -> (want, generation, owner, monotonic stamp, config). One
# register_targets call is one generation. Retirement wipes the target's
# pool (refresh rotates every receiver's Paillier modulus each epoch, so
# a retired key's entries can never be taken again and must not hold
# secrets or byte budget):
#
# - owner-less targets retire after _TARGET_TTL_GENS registrations
#   without a refresh;
# - owned targets follow their owner's lifecycle instead (claim at epoch
#   start, retarget at epoch handover, invalidate_owner on churn or
#   eviction) and are exempt from the generation count: with many
#   interleaved committees each registration ages every other
#   committee's targets. TARGET_TTL_S (wall clock) backstops abandoned
#   owners.
#
# The config rides with the target: the producer's columns take its
# engines (and its device).
_TARGETS: Dict[Tuple[str, object], Tuple[int, int, Optional[object], float, object]] = {}
_TARGETS_LOCK = threading.Lock()
_TARGET_GEN = 0
_TARGET_TTL_GENS = 16
TARGET_TTL_S = 900.0  # the JAX package's FSDKR_POOL_TTL_S default
_PRODUCER = None  # the BackgroundProducer, built at the first kick

# ambient owner for registrations and claims made inside protocol code:
# the serving layer wraps distribute in owner_scope(serve_owner(cid)), so
# clones sharing a mod-N~ fingerprint stay distinct
_REG_OWNER: contextvars.ContextVar = contextvars.ContextVar(
    "fsdkr_precompute_owner", default=None
)

# owner of every ("keys", ...) target: the key-material pool is keyed by
# config parameters alone, so it is shared by every committee with that
# config and never claimed by (or invalidated with) one committee's owner
KEYS_POOL_OWNER = ("keys-pool",)


def committee_owner(dlog_statements) -> tuple:
    """Stable committee fingerprint: the tuple of the committee's mod-N~
    moduli in slot order (public, stable across refreshes, changed only
    by churn)."""
    return ("committee-ntilde",) + tuple(d.N for d in dlog_statements)


@contextlib.contextmanager
def owner_scope(owner):
    """Ambient owner for the block: `claim` and every register_targets
    call without an explicit owner use it. A contextvar, so concurrent
    serving workers tag their own committees."""
    tok = _REG_OWNER.set(owner)
    try:
        yield
    finally:
        _REG_OWNER.reset(tok)


def current_registration_owner():
    return _REG_OWNER.get()


def register_targets(targets, config, owner=None) -> None:
    """Record desired pool depths, targets = [(kind, key, want)] produced
    with `config`'s engines; re-registering refreshes a key's want,
    generation and owner. Sweeps out (and wipes) owner-less targets not
    re-registered for _TARGET_TTL_GENS calls and any target older than
    TARGET_TTL_S."""
    global _TARGET_GEN

    if owner is None:
        owner = _REG_OWNER.get()
    now = time.monotonic()
    stale = []
    with _TARGETS_LOCK:
        _TARGET_GEN += 1
        for kind, key, want in targets:
            _TARGETS[(kind, key)] = (int(want), _TARGET_GEN, owner, now, config)
        for k, (_want, gen, o, stamp, _c) in list(_TARGETS.items()):
            gen_stale = o is None and gen <= _TARGET_GEN - _TARGET_TTL_GENS
            if gen_stale or now - stamp > TARGET_TTL_S:
                del _TARGETS[k]
                stale.append(k)
    release(stale)


def _owned(owner) -> List[Tuple[str, object]]:
    """Caller holds _TARGETS_LOCK."""
    return [k for k, v in _TARGETS.items() if v[2] == owner]


def target_keys(owner=None) -> List[Tuple[str, object]]:
    """Registered (kind, key) targets, optionally of one owner."""
    with _TARGETS_LOCK:
        return [k for k, v in _TARGETS.items() if owner is None or v[2] == owner]


def invalidate_targets(keys) -> int:
    """Drop the given (kind, key) targets and wipe their pools now — every
    pool of `keys`, registered or not (prefill can fill a pool a target
    no longer names). Returns the number of targets dropped."""
    keys = list(keys)
    with _TARGETS_LOCK:
        dropped = [k for k in keys if _TARGETS.pop(k, None) is not None]
    release(keys)
    return len(dropped)


def invalidate_owner(owner) -> int:
    """Drop every target registered under `owner` and wipe its pools — the
    churn and eviction entry point (replace re-keys the committee, so the
    old layout's pooled secrets can never be taken). Returns the number
    of targets dropped."""
    if owner is None:
        return 0
    with _TARGETS_LOCK:
        keys = _owned(owner)
        for k in keys:
            del _TARGETS[k]
    release(keys)
    return len(keys)


def suspend_targets(owner) -> int:
    """Unregister `owner`'s targets WITHOUT wiping their pools: an epoch's
    distribute is about to take from them, and a live target would let
    the producer refill pools whose keys rotate at the epoch's end.
    Returns the number of targets removed."""
    if owner is None:
        return 0
    with _TARGETS_LOCK:
        keys = _owned(owner)
        for k in keys:
            del _TARGETS[k]
    return len(keys)


def replace_targets(targets, config, owner) -> None:
    """register_targets plus wipe-on-invalidate for `owner`: any target
    registered under `owner` but absent from `targets` is dropped and its
    pool wiped (an epoch handing over to the next one's keys)."""
    fresh = {(kind, key) for kind, key, _want in targets}
    with _TARGETS_LOCK:
        stale = [k for k in _owned(owner) if k not in fresh]
        for k in stale:
            del _TARGETS[k]
    release(stale)
    register_targets(targets, config, owner=owner)


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


def retarget_committee(local_key, new_n: int, senders: int, config, owner,
                       keys_want=None) -> None:
    """Churn-safe retarget: wipe what `owner` has registered that the
    committee's CURRENT layout no longer wants, register the fresh
    per-receiver targets under `owner` and the key-material target under
    KEYS_POOL_OWNER with `keys_want` (default: one epoch's demand; the
    serving planner passes the fleet-wide figure). The planner calls this
    at admission and after every adopted epoch (the eks just rotated)."""
    fresh = committee_targets(local_key, new_n, senders, config)
    keys_target = fresh.pop()
    replace_targets(fresh, config, owner=owner)
    register_targets(
        [(keys_target[0], keys_target[1], keys_want or keys_target[2])],
        config, owner=KEYS_POOL_OWNER,
    )


def register_committee(local_key, new_n: int, senders: int, config, owner=None) -> None:
    """Register one committee's targets (the key-material one included)
    under `owner` (or the ambient owner)."""
    register_targets(committee_targets(local_key, new_n, senders, config), config, owner)


def clear_targets() -> None:
    with _TARGETS_LOCK:
        _TARGETS.clear()


def claim(owner) -> Optional[List[Tuple[str, object]]]:
    """The per-receiver (kind, key) targets registered under `owner`, taken
    off the registry (`suspend_targets`: their pools stay for the caller
    to take); None when the owner has none — its distribute is inline.
    The key-material target stays: it belongs to KEYS_POOL_OWNER."""
    if owner is None:
        return None
    with _TARGETS_LOCK:
        keys = [k for k in _owned(owner) if k[0] != "keys"]
        for k in keys:
            del _TARGETS[k]
    return keys or None


def release(keys) -> None:
    """Wipe what the pools of `keys` have left: a distribute has taken
    its epoch's entries, and the receivers' keys rotate at its end."""
    store = pools.get_store()
    for kind, key in keys:
        store.drop(kind, key)


def prefill(local_key, new_n: int, senders: int, config) -> int:
    """Synchronous offline fill: register the committee's targets (under
    the ambient owner, else `committee_owner`) and bring every pool of
    the committee up to one epoch of depth with `config`'s engines, one
    batch a kind, so its next distribute takes the pooled branch. Returns
    the number of entries produced."""
    targets = committee_targets(local_key, new_n, senders, config)
    owner = _REG_OWNER.get()
    if owner is None:
        owner = committee_owner(local_key.h1_h2_n_tilde_vec[:new_n])
    keys_target = targets.pop()
    register_targets(targets, config, owner=owner)
    register_targets([keys_target], config, owner=KEYS_POOL_OWNER)
    store = pools.get_store()
    produced = 0
    for kind in ("enc", "pdl", "alice", "keys"):
        wants = [(key, store.room(k, key, want))
                 for k, key, want in targets + [keys_target] if k == kind]
        produced += produce_batch(kind, wants, config)
    return produced


# ---------------------------------------------------------------------------
# the background producer


def _deficits() -> List[Tuple[str, object, int, object]]:
    """(kind, key, room, config) of every target under its depth."""
    store = pools.get_store()
    with _TARGETS_LOCK:
        items = list(_TARGETS.items())
    out = []
    for (kind, key), (want, _gen, _owner, _stamp, config) in items:
        room = store.room(kind, key, want)
        if room > 0:
            out.append((kind, key, room, config))
    return out


def deficit_total() -> int:
    """Entries still missing across every registered target (0: every
    pool at depth)."""
    return sum(room for _kind, _key, room, _c in _deficits())


def _step() -> bool:
    """One bounded production step: the first deficit's kind and config,
    every deficit of that kind and config batched into one set of columns
    (_PAIR_BATCH entries a pool, _KEY_BATCH key bundles). Returns False
    when every target is at depth OR nothing could be stored (the byte
    budget binds: depth alone would report work forever while every put
    is wiped) — the thread then parks until the next kick."""
    deficits = _deficits()
    if not deficits:
        return False
    kind, _key, _room, config = deficits[0]
    cap = _KEY_BATCH if kind == "keys" else _PAIR_BATCH
    wants = [(key, min(room, cap)) for k, key, room, c in deficits
             if k == kind and c == config]
    from ..ops import tally

    # the step span is the producer thread's unit of work in the trace;
    # produce_batch opens the per-kind child span under it
    with tally.apart("producer"), phase("precompute.producer.step"):
        return produce_batch(kind, wants, config) > 0


def _producer():
    global _PRODUCER
    if _PRODUCER is None:
        from ..utils.pipeline import BackgroundProducer

        _PRODUCER = BackgroundProducer(_step)
    return _PRODUCER


def _register_gauges() -> None:
    """Producer-occupancy telemetry, read at snapshot time; zeros before
    the first kick."""
    from ..telemetry import registry

    registry.gauge(
        "fsdkr_producer_occupancy",
        "background producer busy-fraction since first start (0..1)",
    ).set_function(lambda: _PRODUCER.occupancy() if _PRODUCER else 0.0)
    registry.gauge(
        "fsdkr_producer_busy_seconds",
        "background producer cumulative productive seconds",
    ).set_function(lambda: _PRODUCER.busy_seconds if _PRODUCER else 0.0)
    registry.gauge(
        "fsdkr_producer_steps",
        "background producer lifetime productive steps",
    ).set_function(lambda: _PRODUCER.steps if _PRODUCER else 0)
    registry.gauge(
        "fsdkr_producer_errors",
        "background producer lifetime step exceptions",
    ).set_function(lambda: _PRODUCER.errors if _PRODUCER else 0)


_register_gauges()


def kick() -> None:
    """Wake (starting if needed) the background producer; a no-op while
    no target is registered."""
    with _TARGETS_LOCK:
        if not _TARGETS:
            return
    _producer().kick()


def stop_background(timeout: float = 5.0) -> None:
    """Stop the producer thread; raises the first exception one of its
    steps raised (BackgroundProducer.stop)."""
    if _PRODUCER is not None:
        _PRODUCER.stop(timeout=timeout)


def producer_running() -> bool:
    return _PRODUCER is not None and _PRODUCER.running()


def producer_error() -> Optional[BaseException]:
    """The first exception a producer step raised since the last stop."""
    return _PRODUCER.error() if _PRODUCER is not None else None
