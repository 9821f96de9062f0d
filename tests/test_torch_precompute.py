"""The port's precompute pools and producer (fsdkr_tpu_torch/precompute)
against the JAX package's, n=3, TEST_CONFIG widths.

- PARITY: with the same deterministic samplers installed in both
  packages, and the same canned key material (made once by the JAX
  package and carried over with fsdkr_tpu_torch.carry), the port's
  `distribute_batch` gives the JAX package's wire bytes
  (protocol/serialization.py), inline (no prefill), pooled (prefilled)
  and dry (the committee prefilled at no depth), against the JAX package with
  its FSDKR_CRT on and off, and the same decryption keys. The host
  backend runs every arm; the pooled arm runs once more on the cuda
  backend's plain versions (device="cpu"), its producer on the device
  route.
- SINGLE USE, DEPTH/BUDGET/WIPE, the prefilled committees' lifecycle
  (prefill, claim, release, invalidate), and a committee never prefilled
  taking no pool branch.
- DRY FALLBACK: a tampered round raises the same error in every mode,
  the JAX package's class.
- CONCURRENCY: a producer thread fills pools while the protocol runs and
  consumes them; the rounds verify.
- ISOLATION: pooled secrets never reach the public precompute cache.
"""

import copy
import dataclasses
import hashlib
import math
import threading
from types import SimpleNamespace

import pytest

import fsdkr_tpu.core.intops as j_intops
import fsdkr_tpu.core.paillier as j_paillier
import fsdkr_tpu.core.secp256k1 as j_secp
import fsdkr_tpu.core.vss as j_vss
from fsdkr_tpu import precompute as j_precompute
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.proofs.alice_range import AliceProof as JAlice
from fsdkr_tpu.proofs.pdl_slack import PDLwSlackProof as JPDL
from fsdkr_tpu.proofs.ring_pedersen import RingPedersenProof as JRPProof
from fsdkr_tpu.proofs.ring_pedersen import RingPedersenStatement as JRPStatement
from fsdkr_tpu.protocol import RefreshMessage as JRefresh
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu.protocol.serialization import refresh_message_to_json as jax_to_json

import fsdkr_tpu_torch.core.intops as p_intops
import fsdkr_tpu_torch.core.paillier as p_paillier
import fsdkr_tpu_torch.core.secp256k1 as p_secp
import fsdkr_tpu_torch.core.vss as p_vss
from fsdkr_tpu_torch import TEST_CONFIG, precompute
from fsdkr_tpu_torch.backend import crt as port_crt
from fsdkr_tpu_torch.carry import from_reference
from fsdkr_tpu_torch.errors import FsDkrError, PrecomputeReuseError
from fsdkr_tpu_torch.proofs.alice_range import AliceProof
from fsdkr_tpu_torch.proofs.pdl_slack import PDLwSlackProof
from fsdkr_tpu_torch.proofs.ring_pedersen import (
    RingPedersenProof,
    RingPedersenStatement,
    RingPedersenWitness,
)
from fsdkr_tpu_torch.protocol import RefreshMessage
from fsdkr_tpu_torch.protocol.serialization import refresh_message_to_json

T, N = 1, 3
HOST = dataclasses.replace(TEST_CONFIG, backend="host")
DEVICE_CPU = TEST_CONFIG  # backend "cuda" on device "cpu": the plain versions
Q = p_secp.N
Q3 = Q**3

JAX = SimpleNamespace(
    vss=j_vss, intops=j_intops, paillier=j_paillier, Scalar=j_secp.Scalar,
    PDL=JPDL, Alice=JAlice, RPProof=JRPProof, RPStatement=JRPStatement,
)
PORT = SimpleNamespace(
    vss=p_vss, intops=p_intops, paillier=p_paillier, Scalar=p_secp.Scalar,
    PDL=PDLwSlackProof, Alice=AliceProof, RPProof=RingPedersenProof,
    RPStatement=RingPedersenStatement,
)


# ---------------------------------------------------------------------------
# deterministic sampling harness (tests/test_precompute.py's, for both
# packages)


def _det_below(tag, key, idx, bound):
    """A pure function of (tag, key, idx) in [0, bound): any consumption
    ORDER of per-key streams gives the same values, which a global seed
    cannot (pooled and inline runs interleave their draws)."""
    nbytes = (bound.bit_length() + 7) // 8 + 16
    seed = repr((tag, key, idx)).encode()
    out = b""
    c = 0
    while len(out) < nbytes:
        out += hashlib.sha256(seed + c.to_bytes(4, "big")).digest()
        c += 1
    return int.from_bytes(out[:nbytes], "big") % bound


def _det_unit(tag, key, idx, modulus):
    j = 0
    while True:
        r = _det_below(tag, (key, j), idx, modulus)
        if r and math.gcd(r, modulus) == 1:
            return r
        j += 1


@pytest.fixture(scope="module")
def jax_keys():
    return jax_keygen(T, N, JAX_CONFIG)


@pytest.fixture(scope="module")
def canned():
    """Key material made once by the JAX package: (ek, dk) pairs and
    ring-Pedersen (statement, witness) pairs, and the port's carried
    copies."""
    kb = j_paillier.keygen_batch(JAX_CONFIG.paillier_bits, N)
    rp = JRPStatement.generate_batch(N, JAX_CONFIG)
    port_kb = [(from_reference(ek), from_reference(dk)) for ek, dk in kb]
    port_rp = [
        (from_reference(st), RingPedersenWitness(p=w.p, q=w.q, lam=w.lam, phi=w.phi))
        for st, w in rp
    ]
    return {"jax": (kb, rp), "port": (port_kb, port_rp)}


def _install(monkeypatch, pkg, canned_pair, bits):
    """Patch every sampling surface of `pkg`'s distribute to the
    deterministic streams; returns a reset() for the next arm."""
    counters = {}
    kb, rp = canned_pair
    cursors = {"k": 0, "r": 0}

    def nxt(key):
        v = counters.get(key, 0)
        counters[key] = v + 1
        return v

    def det_sample_poly(t, n, secret):
        k = nxt(("poly", t, n, secret.v))
        coeffs = [secret] + [
            pkg.Scalar(_det_below("poly", (t, n, secret.v, k), j, Q)) for j in range(t)
        ]
        shares = []
        for i in range(1, n + 1):
            acc = 0
            for c in reversed(coeffs):
                acc = (acc * i + c.v) % Q
            shares.append(pkg.Scalar(acc))
        return coeffs, shares

    def det_unit(modulus):
        return _det_unit("unit", modulus, nxt(("unit", modulus)), modulus)

    def det_pdl_sample(ntv, nv):
        alpha, beta, rho, gamma = [], [], [], []
        for nt, n_ in zip(ntv, nv):
            i = nxt(("pdl", nt, n_))
            alpha.append(_det_below("pdl.alpha", (nt, n_), i, Q3))
            beta.append(1 + _det_below("pdl.beta", (nt, n_), i, n_ - 1))
            rho.append(_det_below("pdl.rho", (nt, n_), i, Q * nt))
            gamma.append(_det_below("pdl.gamma", (nt, n_), i, Q3 * nt))
        return alpha, beta, rho, gamma

    def det_alice_sample(ntv, nv, q_=Q):
        alpha, beta, gamma, rho = [], [], [], []
        for nt, n_ in zip(ntv, nv):
            i = nxt(("alice", nt, n_))
            alpha.append(_det_below("alice.alpha", (nt, n_), i, Q3))
            beta.append(_det_unit("alice.beta", (nt, n_), i, n_))
            gamma.append(_det_below("alice.gamma", (nt, n_), i, Q3 * nt))
            rho.append(_det_below("alice.rho", (nt, n_), i, Q * nt))
        return alpha, beta, gamma, rho

    def det_rp_sample(witnesses, m_security=32):
        out = []
        for w in witnesses:
            i = nxt(("rp", w.phi))
            out.append([_det_below("rp.a", (w.phi, i), j, w.phi) for j in range(m_security)])
        return out

    def canned_keygen_batch(b, count):
        assert b == bits
        got = kb[cursors["k"] : cursors["k"] + count]
        cursors["k"] += count
        assert len(got) == count, "canned key material exhausted"
        # fresh dk objects: collect zeroizes them
        return [(ek, type(dk)(dk.p, dk.q)) for ek, dk in got]

    def canned_generate_batch(count, config=None):
        got = rp[cursors["r"] : cursors["r"] + count]
        cursors["r"] += count
        assert len(got) == count, "canned ring-Pedersen material exhausted"
        return list(got)

    monkeypatch.setattr(pkg.vss, "sample_poly", det_sample_poly)
    monkeypatch.setattr(pkg.intops, "sample_unit", det_unit)
    monkeypatch.setattr(pkg.PDL, "sample_stage1", staticmethod(det_pdl_sample))
    monkeypatch.setattr(pkg.Alice, "sample_stage1", staticmethod(det_alice_sample))
    monkeypatch.setattr(pkg.RPProof, "sample_commit", staticmethod(det_rp_sample))
    monkeypatch.setattr(pkg.paillier, "keygen_batch", canned_keygen_batch)
    monkeypatch.setattr(pkg.RPStatement, "generate_batch", staticmethod(canned_generate_batch))

    def reset():
        counters.clear()
        cursors["k"] = cursors["r"] = 0

    return reset


def _clear_both():
    for pc in (precompute, j_precompute):
        pc.clear_pools()
    precompute.clear_committees()
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
    jreset = _install(monkeypatch, JAX, canned["jax"], JAX_CONFIG.paillier_bits)
    preset = _install(monkeypatch, PORT, canned["port"], TEST_CONFIG.paillier_bits)
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


def test_pooled_on_the_device_route_matches_jax(monkeypatch, samplers, jax_keys):
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
