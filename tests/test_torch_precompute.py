"""The port's precompute pools and producer (fsdkr_tpu_torch/precompute)
against the JAX package's, n=3, TEST_CONFIG widths.

- PARITY: with the same deterministic samplers installed in both
  packages (tests/_torch_samplers.py), and the same canned key material
  (made once by the JAX package and carried over with
  fsdkr_tpu_torch.carry), the port's `distribute_batch` gives the JAX
  package's wire bytes (protocol/serialization.py), inline (no
  prefill), pooled (prefilled) and dry (the committee prefilled at no
  depth), against the JAX package with its FSDKR_CRT on and off, and the
  same decryption keys. The host backend runs every arm; the pooled arm
  runs once more on the cuda backend's plain versions (device="cpu"),
  its producer on the device route.
- SINGLE USE, DEPTH/BUDGET/WIPE, the target registry's lifecycle
  (prefill, claim, release, invalidate, the TTL, retargeting under an
  owner scope), and a committee with no targets taking no pool branch.
- DRY FALLBACK: a tampered round raises the same error in every mode,
  the JAX package's class.
- CONCURRENCY: a producer thread fills pools while the protocol runs and
  consumes them; the rounds verify. The background producer fills the
  registered targets, wakes on `kick`, stops, and re-raises what a step
  raised.
- ISOLATION: pooled secrets never reach the public precompute cache.
"""

import copy
import dataclasses
import threading

import pytest

from _torch_samplers import JAX, PORT, canned_material, install_samplers
from fsdkr_tpu import precompute as j_precompute
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.protocol import RefreshMessage as JRefresh
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu.protocol.serialization import refresh_message_to_json as jax_to_json

from fsdkr_tpu_torch import TEST_CONFIG, precompute
from fsdkr_tpu_torch.backend import crt as port_crt
from fsdkr_tpu_torch.carry import from_reference
from fsdkr_tpu_torch.errors import FsDkrError, PrecomputeReuseError
from fsdkr_tpu_torch.protocol import RefreshMessage
from fsdkr_tpu_torch.protocol.serialization import refresh_message_to_json

T, N = 1, 3
HOST = dataclasses.replace(TEST_CONFIG, backend="host")
DEVICE_CPU = TEST_CONFIG  # backend "cuda" on device "cpu": the plain versions


@pytest.fixture(scope="module")
def jax_keys():
    return jax_keygen(T, N, JAX_CONFIG)


@pytest.fixture(scope="module")
def canned():
    return canned_material(JAX_CONFIG, N)


def _clear_both():
    for pc in (precompute, j_precompute):
        pc.clear_pools()
    precompute.clear_targets()
    j_precompute.clear_targets()


def _jax_arm(monkeypatch, reset, jkeys, mode):
    reset()
    _clear_both()
    monkeypatch.setenv("FSDKR_PRECOMPUTE", "0" if mode == "off" else "1")
    keys = copy.deepcopy(jkeys)
    if mode == "pooled":
        j_precompute.prefill(keys[0], N, len(keys), JAX_CONFIG)
    res = JRefresh.distribute_batch([(k.i, k) for k in keys], N, JAX_CONFIG)
    return [jax_to_json(m) for m, _ in res], [(dk.p, dk.q) for _, dk in res]


def _port_arm(monkeypatch, reset, jkeys, mode, config):
    reset()
    _clear_both()
    keys = from_reference(jkeys)
    if mode != "off":  # dry: the committee recorded, nothing produced
        precompute.prefill(keys[0], N, len(keys) if mode == "pooled" else 0, config)
    precompute.stats_reset()
    res = RefreshMessage.distribute_batch([(k.i, k) for k in keys], N, config)
    st = precompute.precompute_stats()
    if mode == "off":
        assert st["consumed"] == 0 and st["dry_fallbacks"] == 0
    elif mode == "pooled":
        # n^2 entries of each pair kind, the enc entries and the key bundles
        assert st["consumed"] == 3 * N * len(keys) + len(keys)
        assert st["dry_fallbacks"] == 0
    elif mode == "dry":
        assert st["consumed"] == 0 and st["dry_fallbacks"] > 0
    return [refresh_message_to_json(m) for m, _ in res], [(dk.p, dk.q) for _, dk in res]


@pytest.fixture
def samplers(monkeypatch, canned):
    monkeypatch.setenv("FSDKR_PRECOMPUTE_BG", "0")
    jreset = install_samplers(monkeypatch, JAX, canned["jax"], JAX_CONFIG.paillier_bits)
    preset = install_samplers(monkeypatch, PORT, canned["port"], TEST_CONFIG.paillier_bits)
    yield jreset, preset
    _clear_both()


@pytest.mark.parametrize("multiexp,crt", [("1", "1"), ("0", "1"), ("1", "0")])
def test_wire_bytes_match_jax_inline_pooled_dry(monkeypatch, samplers, jax_keys, multiexp,
                                                crt):
    """The port's wire bytes against the JAX package's at FSDKR_CRT=`crt`:
    the port's CRT legs (S = T^lambda, and the provers' columns on the
    host engine) give the JAX package's full-width values."""
    monkeypatch.setenv("FSDKR_MULTIEXP", multiexp)
    monkeypatch.setenv("FSDKRC_MULTIEXP", multiexp)
    monkeypatch.setenv("FSDKR_CRT", crt)
    jreset, preset = samplers
    jax_off = _jax_arm(monkeypatch, jreset, jax_keys, "off")
    port_crt.stats_reset()
    for mode in ("off", "pooled", "dry"):
        assert _jax_arm(monkeypatch, jreset, jax_keys, mode) == jax_off
        got = _port_arm(monkeypatch, preset, jax_keys, mode, HOST)
        assert got == jax_off, f"{mode}: the port's wire bytes differ from the JAX package's"
    assert port_crt.crt_stats()["rows"] > 0


@pytest.fixture
def one_torch_thread():
    """The plain versions' small tensor ops on one torch thread: several
    threads a process gain nothing on them, and beside the suite's other
    workers they oversubscribe the cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_pooled_on_the_device_route_matches_jax(monkeypatch, samplers, jax_keys,
                                                one_torch_thread):
    """The pooled arm with the producer's columns on the cuda backend's
    plain versions, and the pooled secrets kept out of the public cache
    that the device route fills. The key bundles' public parts (the
    moduli, the statements and the proofs, all broadcast) may key a
    device context there; nothing else of the pools may appear."""
    from fsdkr_tpu_torch.utils import lru

    jreset, preset = samplers
    want = _jax_arm(monkeypatch, jreset, jax_keys, "off")
    lru.clear_caches()
    preset()
    _clear_both()
    keys = from_reference(jax_keys)
    assert precompute.prefill(keys[0], N, len(keys), DEVICE_CPU) == 3 * N * N + N
    public = set()
    for ent in precompute.get_store()._pools[("keys", DEVICE_CPU.key_material_pool_key)]:
        ek, _dk, ck, st, rp_proof = ent._values
        public |= {ek.n, ek.nn, st.N, st.T, st.S, *ck.sigma_vec, *rp_proof.A, *rp_proof.Z}
    pooled = set(precompute.secret_values()) - public
    assert pooled
    assert lru.global_cache().stats()["entries"] > 0  # the device route cached
    for key, value in list(lru.global_cache()._d.items()):
        assert not pooled & (set(_ints(key)) | set(_ints(value)))
    res = RefreshMessage.distribute_batch([(k.i, k) for k in keys], N, DEVICE_CPU)
    got = [refresh_message_to_json(m) for m, _ in res], [(dk.p, dk.q) for _, dk in res]
    assert got == want


def _ints(obj, seen=None):
    """Every int reachable from a cache key or value (containers and the
    port's objects' attributes; tensors are skipped)."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, bool):
        return
    seen.add(id(obj))
    if isinstance(obj, int):
        yield obj
    elif isinstance(obj, (list, tuple, set)):
        for x in obj:
            yield from _ints(x, seen)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _ints(k, seen)
            yield from _ints(v, seen)
    elif hasattr(obj, "__dict__") and type(obj).__module__.startswith("fsdkr_tpu_torch"):
        yield from _ints(vars(obj), seen)


# ---------------------------------------------------------------------------
# the store


def test_single_use_entry_raises_on_reuse():
    precompute.clear_pools()
    store = precompute.get_store()
    assert precompute.put("enc", 101, (2, 4))
    ent = store._pools[("enc", 101)][0]
    assert store.take("enc", 101) == (2, 4)
    with pytest.raises(PrecomputeReuseError):
        ent.take()
    ent2 = precompute.PoolEntry((7,))
    assert ent2.take() == (7,)
    with pytest.raises(PrecomputeReuseError):
        ent2.take()
    assert store.take("enc", 101) is None  # drained: a dry fallback
    precompute.clear_pools()


def test_pool_depth_budget_and_wipe(monkeypatch):
    from fsdkr_tpu_torch.precompute import pools

    monkeypatch.setattr(pools, "POOL_DEPTH", 2)
    precompute.clear_pools()
    precompute.stats_reset()
    assert precompute.put("enc", 103, (1, 2))
    assert precompute.put("enc", 103, (3, 4))
    assert not precompute.put("enc", 103, (5, 6))  # depth cap: wiped
    st = precompute.precompute_stats()
    assert st["produced"] == 2 and st["wiped"] == 1
    assert st["entries"] == 2 and st["bytes_pooled"] > 0
    precompute.clear_pools()
    st = precompute.precompute_stats()
    assert st["entries"] == 0 and st["bytes_pooled"] == 0
    assert st["wiped"] == 3  # the two unconsumed entries were wiped too
    monkeypatch.setattr(pools, "POOL_BUDGET_BYTES", 40)
    assert precompute.put("enc", 104, (1 << 200,))  # 26 bytes
    assert not precompute.put("enc", 104, (1 << 200,))  # over the byte budget
    assert precompute.precompute_stats(by_kind=True)["kinds"]["enc"]["wiped"] == 4
    precompute.clear_pools()


def test_owner_lifecycle_prefill_claim_invalidate(jax_keys):
    _clear_both()
    keys = from_reference(jax_keys)
    owner = precompute.committee_owner(keys[0].h1_h2_n_tilde_vec)
    assert precompute.claim(owner) is None  # never prefilled
    # prefill records the committee's per-receiver pools (at no depth here)
    assert precompute.prefill(keys[0], N, 0, HOST) == 0
    recorded = precompute.claim(owner)
    assert sorted(kind for kind, _ in recorded) == sorted(["enc", "pdl", "alice"] * N)
    assert precompute.claim(owner) is None  # a claim takes it off the record
    # release wipes what the claimed pools have left, not the key material
    kp = HOST.key_material_pool_key
    for kind, key in recorded:
        assert precompute.put(kind, key, (1, 1))
    assert precompute.put("keys", kp, (1,))
    precompute.release(recorded)
    store = precompute.get_store()
    assert all(store.depth(kind, key) == 0 for kind, key in recorded)
    assert store.depth("keys", kp) == 1
    # invalidate: forgets the committee and wipes its pools
    precompute.prefill(keys[0], N, 0, HOST)
    for kind, key in recorded:
        assert precompute.put(kind, key, (2, 2))
    assert precompute.invalidate_owner(owner) == 3 * N
    assert all(store.depth(kind, key) == 0 for kind, key in recorded)
    assert precompute.invalidate_owner(owner) == 0 and precompute.claim(owner) is None
    _clear_both()


def test_replace_invalidates_the_committee_pools(jax_keys):
    """RefreshMessage.replace re-keys the committee: the pooled secrets
    of the layout it changes are wiped before its distribute."""
    _clear_both()
    keys = from_reference(jax_keys)
    owner = precompute.committee_owner(keys[0].h1_h2_n_tilde_vec)
    precompute.prefill(keys[0], N, 0, HOST)
    d, ek = keys[0].h1_h2_n_tilde_vec[1], keys[0].paillier_key_vec[1]
    env = (d.g, d.ni, d.N, ek.n)
    assert precompute.put("pdl", env, (5,))
    key = copy.deepcopy(keys[0])
    RefreshMessage.replace([], key, {1: 1, 2: 2, 3: 3}, N, HOST)
    assert precompute.get_store().depth("pdl", env) == 0
    assert precompute.claim(owner) is None
    _clear_both()


def test_default_distribute_takes_no_pool_branch(jax_keys):
    """A committee never prefilled distributes inline: entries pooled
    under its keys by any other means stay untouched."""
    _clear_both()
    keys = from_reference(jax_keys)
    ek = keys[0].paillier_key_vec[0]
    assert precompute.produce_for("enc", ek.n, 2, HOST) == 2
    precompute.stats_reset()
    res = RefreshMessage.distribute_batch([(k.i, k) for k in keys], N, HOST)
    st = precompute.precompute_stats()
    assert st["consumed"] == 0 and st["dry_fallbacks"] == 0
    assert precompute.get_store().depth("enc", ek.n) == 2
    msgs = [m for m, _ in res]
    RefreshMessage.collect(msgs, keys[0], res[0][1], (), HOST)
    _clear_both()


# ---------------------------------------------------------------------------
# dry fallback and concurrency


def test_tamper_verdict_in_every_mode_is_the_jax_packages(monkeypatch, jax_keys):
    monkeypatch.setenv("FSDKR_PRECOMPUTE_BG", "0")
    monkeypatch.setenv("FSDKR_PRECOMPUTE", "0")
    _clear_both()
    jkeys = copy.deepcopy(jax_keys)
    res = JRefresh.distribute_batch([(k.i, k) for k in jkeys], N, JAX_CONFIG)
    msgs = [m for m, _ in res]
    msgs[1].points_encrypted_vec[0] += 1
    with pytest.raises(Exception) as ei:
        JRefresh.collect(msgs, jkeys[0], res[0][1], (), JAX_CONFIG)
    want = type(ei.value).__name__
    for mode in ("off", "dry", "pooled"):
        _clear_both()
        keys = from_reference(jax_keys)
        if mode != "off":  # dry: the committee recorded, nothing produced
            precompute.prefill(keys[0], N, N if mode == "pooled" else 0, HOST)
        out = RefreshMessage.distribute_batch([(k.i, k) for k in keys], N, HOST)
        pmsgs = [m for m, _ in out]
        pmsgs[1].points_encrypted_vec[0] += 1
        with pytest.raises(FsDkrError) as pe:
            RefreshMessage.collect(pmsgs, keys[0], out[0][1], (), HOST)
        assert type(pe.value).__name__ == want, mode
        assert pe.value.party_index == pmsgs[1].party_index, mode
    _clear_both()


def test_concurrent_producer_and_consumer(jax_keys):
    """A producer thread prefills the committee while two epochs run
    beside it (a distribute may claim pools the thread is still filling:
    what it finds it takes once, the rest it computes inline); then a
    prefill for the new keys and a round that takes it. Every round
    verifies and the thread raises nothing."""
    _clear_both()
    keys = from_reference(jax_keys)
    errors = []

    def produce():
        try:
            for _ in range(2):
                precompute.prefill(keys[0], N, N, HOST)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def epoch():
        res = RefreshMessage.distribute_batch([(k.i, k) for k in keys], N, HOST)
        msgs = [m for m, _ in res]
        for k, (_m, dk) in zip(keys, res):
            RefreshMessage.collect(msgs, k, dk, (), HOST)

    try:
        producer = threading.Thread(target=produce)
        producer.start()
        for _epoch in range(2):
            epoch()
        producer.join(timeout=120)
        assert not producer.is_alive() and not errors, errors
        precompute.clear_pools()  # what the thread left for rotated keys
        precompute.stats_reset()
        assert precompute.prefill(keys[0], N, N, HOST) == 3 * N * N + N
        epoch()
        st = precompute.precompute_stats()
        assert st["consumed"] == 3 * N * N + N and st["dry_fallbacks"] == 0
    finally:
        _clear_both()


# ---------------------------------------------------------------------------
# the target registry and the background producer


def _wait(cond, timeout=120.0):
    import time

    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.01)


def test_background_producer_fills_the_planners_targets(jax_keys):
    """The serving planner's targets under `serve_owner`: `kick` starts
    the producer, which fills them; a distribute under that owner's scope
    claims and takes them all; `stop_background` stops the thread."""
    from fsdkr_tpu_torch.serving import SLO, CapacityPlanner, serve_owner

    _clear_both()
    keys = from_reference(jax_keys)
    planner = CapacityPlanner()
    planner.register("c1", keys[0], N, HOST, SLO(arrival_rate_hz=0.01))
    owner = serve_owner("c1")
    assert sorted(k for k, _ in precompute.target_keys(owner)) == sorted(
        ["enc", "pdl", "alice"] * N)
    assert precompute.target_keys(precompute.KEYS_POOL_OWNER) == [
        ("keys", HOST.key_material_pool_key)]
    try:
        precompute.kick()
        _wait(lambda: precompute.deficit_total() == 0)
        assert precompute.producer_running()
        precompute.stats_reset()
        with precompute.owner_scope(owner):
            assert precompute.current_registration_owner() == owner
            res = RefreshMessage.distribute_batch([(k.i, k) for k in keys], N, HOST)
        st = precompute.precompute_stats()
        assert st["consumed"] == 3 * N * N + N and st["dry_fallbacks"] == 0
        assert precompute.target_keys(owner) == []  # claimed for the epoch
        msgs = [m for m, _ in res]
        RefreshMessage.collect(msgs, keys[0], res[0][1], (), HOST)
        # the epoch handed over: retarget to the rotated keys, refill
        planner.retarget("c1")
        precompute.kick()
        _wait(lambda: precompute.deficit_total() == 0)
        store = precompute.get_store()
        assert all(store.depth(kind, key) == N for kind, key in precompute.target_keys(owner))
    finally:
        precompute.stop_background()
        _clear_both()
    assert not precompute.producer_running()


def test_retarget_ttl_and_invalidate_on_eviction(monkeypatch, jax_keys):
    from fsdkr_tpu_torch.precompute import producer
    from fsdkr_tpu_torch.serving import RefreshService, serve_owner

    _clear_both()
    keys = from_reference(jax_keys)
    owner = ("serve", "x")
    precompute.retarget_committee(keys[0], N, N, HOST, owner=owner)
    old = precompute.target_keys(owner)
    for kind, key in old:
        assert precompute.put(kind, key, (1, 1))
    # a retarget to another layout wipes what the old one registered and
    # the new one does not want: the receivers' moduli move to other
    # mod-N~ environments, so every pdl/alice key changes, no enc key
    moved = copy.deepcopy(keys[0])
    moved.paillier_key_vec = moved.paillier_key_vec[1:] + moved.paillier_key_vec[:1]
    precompute.retarget_committee(moved, N, N, HOST, owner=owner)
    store = precompute.get_store()
    new = set(precompute.target_keys(owner))
    for kind, key in old:
        kept = kind == "enc"
        assert ((kind, key) in new) == kept
        assert store.depth(kind, key) == (1 if kept else 0)
    # owner-less targets age out after 16 registrations; every target
    # past the wall-clock TTL goes at the next registration
    precompute.register_targets([("enc", 7, 1)], HOST)
    assert precompute.put("enc", 7, (1, 1))
    for i in range(16):
        precompute.register_targets([("enc", 1000 + i, 1)], HOST)
    assert ("enc", 7) not in precompute.target_keys() and store.depth("enc", 7) == 0
    assert precompute.target_keys(owner)  # owned: exempt from the count
    monkeypatch.setattr(producer, "TARGET_TTL_S", -1.0)
    precompute.register_targets([], HOST)
    assert precompute.target_keys() == []
    monkeypatch.undo()
    # register_committee: every target under one owner, the key material's
    # too; invalidate_targets drops the named ones and wipes their pools
    precompute.register_committee(keys[0], N, N, HOST, owner=owner)
    mine = precompute.target_keys(owner)
    assert len(mine) == 3 * N + 1 and ("keys", HOST.key_material_pool_key) in mine
    assert precompute.put(*mine[0], (3, 3))
    assert precompute.invalidate_targets(mine[:2] + [("enc", 99)]) == 2
    assert store.depth(*mine[0]) == 0 and len(precompute.target_keys(owner)) == 3 * N - 1
    precompute.clear_targets()
    # eviction invalidates the committee's serving owner and wipes its pools
    svc = RefreshService(device="cpu")
    svc.admit("c2", keys, HOST)
    mine = precompute.target_keys(serve_owner("c2"))
    assert len(mine) == 3 * N
    for kind, key in mine:
        assert precompute.put(kind, key, (2, 2))
    svc.evict("c2")
    assert precompute.target_keys(serve_owner("c2")) == []
    assert all(store.depth(kind, key) == 0 for kind, key in mine)
    svc.stop()
    _clear_both()


def test_a_step_exception_is_reraised_from_stop(monkeypatch, jax_keys):
    """A producer step that raises (on the card: a kernel that does not
    build or launch) parks the thread, is counted, and is raised by
    `stop_background` and by the service's `stats()`, not forgotten."""
    from fsdkr_tpu_torch.precompute import producer
    from fsdkr_tpu_torch.serving import RefreshService
    from fsdkr_tpu_torch.telemetry import registry

    _clear_both()
    keys = from_reference(jax_keys)

    def broken(kind, wants, config):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(producer, "produce_batch", broken)
    errors = registry.get_registry().get("fsdkr_producer_errors")
    e0 = errors.snapshot_values()[0]["value"]
    svc = RefreshService(device="cpu")
    svc.admit("c3", keys, HOST)
    try:
        svc.start()
        _wait(lambda: precompute.producer_error() is not None)
        assert errors.snapshot_values()[0]["value"] == e0 + 1
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            svc.stats()
    finally:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            svc.stop()
        _clear_both()
    assert precompute.producer_error() is None  # raised once, then cleared
    precompute.stop_background()  # nothing more to raise
