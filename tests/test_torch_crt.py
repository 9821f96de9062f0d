"""The port's secret-CRT engine (fsdkr_tpu_torch/backend/crt.py) against
the JAX package's (FSDKR_CRT), at 512-1024 bits.

- The same numpy-seeded inputs give the same values in both packages,
  with CRT on and off: `crt_modexp_batch`, `crt_powm_shared`,
  `fault_checked_powm`, the correct-key prover, ring-Pedersen's prover
  and generator, and Paillier `decrypt`. "On" is the JAX package's
  FSDKR_CRT=1 and the port's host engine, whose prover columns take the
  CRT legs; "off" is FSDKR_CRT=0 and the port's device engine on the CPU
  (the cuda backend's plain versions), which takes them at full width.
- A corrupted leg raises CrtFaultError before any output (the port's leg
  engines monkeypatched to fault).
- No factorization-derived integer reaches the public precompute cache
  (utils/lru.py), while a device-route column on the CPU does fill it.
- The legs, and the fixed-base column's rows that cannot take them, run
  on GMP's constant-time mpz_powm_sec (native/gmp.py, `secret=True`);
  the values and the fault checks are the JAX package's.
"""

import random
from functools import partial

import numpy as np
import pytest

from fsdkr_tpu.backend import crt as jcrt
from fsdkr_tpu.core import paillier as jpaillier
from fsdkr_tpu.proofs import correct_key as jck
from fsdkr_tpu.proofs import ring_pedersen as jrp
from fsdkr_tpu_torch import TEST_CONFIG, native
from fsdkr_tpu_torch.backend import crt
from fsdkr_tpu_torch.backend.powm import crt_powm, device_powm_grouped
from fsdkr_tpu_torch.carry import from_reference
from fsdkr_tpu_torch.core import paillier, primes
from fsdkr_tpu_torch.errors import CrtFaultError
from fsdkr_tpu_torch.native import gmp
from fsdkr_tpu_torch.proofs import ring_pedersen as rp
from fsdkr_tpu_torch.proofs.correct_key import NiCorrectKeyProof

RNG = np.random.default_rng(0xC127)


def _rand_int(bits):
    words = RNG.integers(0, 1 << 32, size=(bits + 31) // 32, dtype=np.uint64)
    x = 0
    for w in words:
        x = (x << 32) | int(w)
    return (x >> (len(words) * 32 - bits)) | (1 << (bits - 1))


def _prime(bits):
    c = _rand_int(bits) | 1 | (1 << (bits - 2))
    while not primes.is_probable_prime(c, 20):
        c += 2
    return c


@pytest.fixture(scope="module")
def moduli():
    """(n, p, q) at 512, 768 and 1024 bits, from numpy-seeded primes."""
    out = []
    for bits in (512, 768, 1024):
        p, q = _prime(bits // 2), _prime(bits // 2)
        out.append((p * q, p, q))
    return out


# the cuda backend's engine on the CPU: the plain versions, full width
DEVICE_CPU = partial(device_powm_grouped, device="cpu")


@pytest.fixture
def both_gates(monkeypatch):
    """Sets the JAX package's CRT knob and returns the port's engine of
    the same route: None (the host engine, CRT legs) when on, the device
    engine on the CPU when off."""

    def set_gate(on):
        monkeypatch.setenv("FSDKR_CRT", "1" if on else "0")
        return None if on else DEVICE_CPU

    return set_gate


class _SeededSecrets:
    """Deterministic stand-in for a proof module's `secrets`: both
    packages draw the same nonces."""

    def __init__(self, seed):
        self._rng = random.Random(seed)

    def randbelow(self, bound):
        return self._rng.randrange(bound)

    def randbits(self, k):
        return self._rng.getrandbits(k)


@pytest.mark.parametrize("square", [False, True], ids=["n", "n2"])
def test_crt_modexp_batch_matches_jax(moduli, both_gates, square):
    both_gates(True)
    rows_b, rows_e, port_ctx, jax_ctx, want = [], [], [], [], []
    for n, p, q in moduli:
        mod = n * n if square else n
        for _ in range(3):
            b, e = _rand_int(mod.bit_length() - 1) % mod, _rand_int(mod.bit_length())
            rows_b.append(b)
            rows_e.append(e)
            port_ctx.append(crt.get_context(mod, p, q))
            jax_ctx.append(jcrt.get_context(mod, p, q))
            want.append(pow(b, e, mod))
    # a non-unit base and a row with no context take the fallback
    n, p, q = moduli[0]
    mod = n * n if square else n
    rows_b += [p * 5, 7]
    rows_e += [12345, 999]
    port_ctx += [crt.get_context(mod, p, q), None]
    jax_ctx += [jcrt.get_context(mod, p, q), None]
    want += [pow(p * 5, 12345, mod), pow(7, 999, mod)]
    mods = [0] * (len(rows_b) - 1) + [mod]
    got = crt.crt_modexp_batch(rows_b, rows_e, port_ctx, moduli=mods)
    assert got == want
    assert got == jcrt.crt_modexp_batch(rows_b, rows_e, jax_ctx, moduli=mods)
    st = crt.crt_stats()
    assert st["fallback_rows"] >= 2 and st["legs"] >= 2 * 9


@pytest.mark.parametrize("on", [True, False])
def test_crt_powm_route_and_shared_match_jax(moduli, both_gates, on):
    powm = both_gates(on)
    from fsdkr_tpu.backend.powm import crt_powm as jcrt_powm

    n, p, q = moduli[1]
    bases = [_rand_int(700) for _ in range(4)]
    exps = [_rand_int(768) for _ in range(4)]
    factors = [(p, q), (p, q), None, (p, q)]
    crt.stats_reset()
    got = crt_powm(bases, exps, [n] * 4, factors, powm)
    assert got == [pow(b, e, n) for b, e in zip(bases, exps)]
    assert got == jcrt_powm(bases, exps, [n] * 4, factors)
    # the host engine takes the legs, a device engine the full width
    assert crt.crt_stats()["rows"] == (3 if on else 0)

    base = pow(_rand_int(700), 2, n)
    col = [0, 1, (p - 1) * (q - 1) - 1] + [_rand_int(768) for _ in range(9)]
    got = crt.crt_powm_shared(base, col, crt.get_context(n, p, q))
    assert got == [pow(base, e, n) for e in col]
    assert got == jcrt.crt_powm_shared(base, col, jcrt.get_context(n, p, q))


@pytest.mark.parametrize("threads", [1, 4])
def test_legs_run_on_gmp_secret_rows(moduli, both_gates, threads):
    """crt_modexp_batch's legs and fault_checked_powm's leg are secret
    rows of one GMP batch; crt_powm_shared's column with a non-unit base
    or a negative exponent is too (at full width), equal to the JAX
    package's at 1 and 4 threads."""
    both_gates(True)
    n, p, q = moduli[1]
    ctx, jctx = crt.get_context(n, p, q), jcrt.get_context(n, p, q)
    bases = [_rand_int(700) for _ in range(5)]
    exps = [_rand_int(768) for _ in range(5)]
    native.set_threads(threads)
    try:
        gmp.stats_reset()
        got = crt.crt_modexp_batch(bases, exps, [ctx] * 5)
        st = gmp.stats()
        assert (st["powm_batches"], st["powm_rows"], st["powm_sec_rows"]) == (1, 10, 10)
        assert got == [pow(b, e, n) for b, e in zip(bases, exps)]
        assert got == jcrt.crt_modexp_batch(bases, exps, [jctx] * 5)

        gmp.stats_reset()
        leg = crt.fault_checked_powm(bases[0], p - 1, p * p)
        assert leg == jcrt.fault_checked_powm(bases[0], p - 1, p * p)
        assert gmp.stats()["powm_sec_rows"] == 1

        base = pow(_rand_int(700), 2, n)
        for b, col in ((p * 3, exps), (base, [5, -3, 0, _rand_int(768)])):
            crt.stats_reset()
            gmp.stats_reset()
            got = crt.crt_powm_shared(b, col, ctx)
            assert got == jcrt.crt_powm_shared(b, col, jctx)
            assert got == [pow(b, e, n) for e in col]
            assert crt.crt_stats()["fallback_rows"] == len(col)
            # exponent 0 and the negative exponent are not mpz_powm_sec rows
            nonpos = sum(e <= 0 for e in col)
            assert gmp.stats()["powm_sec_rows"] == len(col) - nonpos
    finally:
        native.set_threads(0)


def test_fault_checked_powm_matches_jax(moduli):
    _, p, _ = moduli[2]
    base, exp = _rand_int(1000) % (p * p), p - 1
    got = crt.fault_checked_powm(base, exp, p * p)
    assert got == pow(base, exp, p * p) == jcrt.fault_checked_powm(base, exp, p * p)
    with pytest.raises(ValueError):
        crt.fault_checked_powm(p, exp, p * p)


@pytest.mark.parametrize("on", [True, False])
def test_correct_key_matches_jax(moduli, both_gates, on):
    powm = both_gates(on)
    dks = [paillier.DecryptionKey(p=p, q=q) for _, p, q in moduli[:2]]
    jdks = [jpaillier.DecryptionKey(p=p, q=q) for _, p, q in moduli[:2]]
    got = NiCorrectKeyProof.proof_batch(dks, rounds=3, powm=powm)
    want = jck.NiCorrectKeyProof.proof_batch(jdks, rounds=3)
    assert [pf.sigma_vec for pf in got] == [pf.sigma_vec for pf in want]
    for pf, (n, _, _) in zip(got, moduli):
        assert pf.verify(paillier.EncryptionKey.from_n(n), rounds=3)


@pytest.mark.parametrize("on", [True, False])
def test_ring_pedersen_prove_matches_jax(moduli, both_gates, monkeypatch, on):
    powm = both_gates(on)
    stmts, wits, jstmts, jwits = [], [], [], []
    for n, p, q in moduli[:2]:
        phi = (p - 1) * (q - 1)
        lam = _rand_int(n.bit_length() - 2) % phi
        t = pow(_rand_int(n.bit_length() - 2), 2, n)
        s = pow(t, lam, n)
        stmts.append(rp.RingPedersenStatement(S=s, T=t, N=n, ek=paillier.EncryptionKey.from_n(n)))
        wits.append(rp.RingPedersenWitness(p=p, q=q, lam=lam, phi=phi))
        jstmts.append(jrp.RingPedersenStatement(S=s, T=t, N=n, ek=jpaillier.EncryptionKey.from_n(n)))
        jwits.append(jrp.RingPedersenWitness(p=p, q=q, lam=lam, phi=phi))
    monkeypatch.setattr(rp, "secrets", _SeededSecrets(0xABCD))
    monkeypatch.setattr(jrp, "secrets", _SeededSecrets(0xABCD))
    crt.stats_reset()
    got = rp.RingPedersenProof.prove_batch(wits, stmts, 16, powm)
    assert (crt.crt_stats()["rows"] > 0) == on
    want = jrp.RingPedersenProof.prove_batch(jwits, jstmts, 16)
    assert [(pf.A, pf.Z) for pf in got] == [(pf.A, pf.Z) for pf in want]
    for pf, st in zip(got, stmts):
        pf.verify(st, 16)


@pytest.mark.parametrize("on", [True, False])
def test_ring_pedersen_generate_is_exact(both_gates, on):
    powm = both_gates(on)
    crt.stats_reset()
    for st, w in rp.RingPedersenStatement.generate_batch(2, TEST_CONFIG):
        assert st.S == pow(st.T, w.lam, st.N)
        proof = rp.RingPedersenProof.prove(w, st, 16, powm)
        proof.verify(st, 16)
        # the statement carries across to the JAX package and verifies there
        jst = jrp.RingPedersenStatement(
            S=st.S, T=st.T, N=st.N, ek=jpaillier.EncryptionKey.from_n(st.N))
        jrp.RingPedersenProof(A=proof.A, Z=proof.Z).verify(jst, 16)
    # S = T^lambda takes the legs on either engine: one row a statement
    assert crt.crt_stats()["rows"] >= 2


@pytest.mark.parametrize("on", [True, False])
def test_decrypt_matches_jax(moduli, both_gates, on):
    both_gates(on)
    n, p, q = moduli[2]
    ek, dk = paillier.EncryptionKey.from_n(n), paillier.DecryptionKey(p=p, q=q)
    jek, jdk = jpaillier.EncryptionKey.from_n(n), jpaillier.DecryptionKey(p=p, q=q)
    for m in (0, 1, _rand_int(900) % n, n - 1):
        c = paillier.encrypt(ek, m)
        assert paillier.decrypt(dk, ek, c) == m == jpaillier.decrypt(jdk, jek, c)
    # a non-unit ciphertext decrypts through the unchecked legs in both
    c = p * 3
    assert paillier.decrypt(dk, ek, c) == jpaillier.decrypt(jdk, jek, c)
    assert from_reference(jdk) == dk


def _corrupting(fn, bump_row):
    def wrapped(bases, exps, mods):
        out = fn(bases, exps, mods)
        out[bump_row] = (out[bump_row] + 1) % mods[bump_row]
        return out

    return wrapped


def test_corrupted_leg_raises_before_output(moduli, both_gates, monkeypatch):
    both_gates(True)
    n, p, q = moduli[0]
    ctx = crt.get_context(n, p, q)
    bs = [_rand_int(500) | 1 for _ in range(3)]
    es = [_rand_int(512) for _ in range(3)]
    real = crt._leg_powm
    for bad_leg in (0, 4):  # a p-leg and a q-leg
        monkeypatch.setattr(crt, "_leg_powm", _corrupting(real, bad_leg))
        with pytest.raises(CrtFaultError):
            crt.crt_modexp_batch(bs, es, [ctx] * 3)
        with pytest.raises(CrtFaultError):
            crt_powm(bs, es, [n] * 3, [(p, q)] * 3)
    # the fault-checked single leg, and decrypt through it
    monkeypatch.setattr(crt, "_leg_powm", _corrupting(real, 0))
    with pytest.raises(CrtFaultError):
        crt.fault_checked_powm(_rand_int(500) | 1, p - 1, p * p)
    ek, dk = paillier.EncryptionKey.from_n(n), paillier.DecryptionKey(p=p, q=q)
    with pytest.raises(CrtFaultError):
        paillier.decrypt(dk, ek, paillier.encrypt(ek, 42))
    monkeypatch.setattr(crt, "_leg_powm", real)

    real_shared = native.modexp_shared

    def corrupted_shared(base, exps, mod):
        out = real_shared(base, exps, mod)
        out[1] = (out[1] + 1) % mod
        return out

    monkeypatch.setattr(native, "modexp_shared", corrupted_shared)
    with pytest.raises(CrtFaultError):
        crt.crt_powm_shared(pow(_rand_int(500), 2, n), [_rand_int(256) for _ in range(4)], ctx)


def _ints(obj, seen=None):
    """Every int reachable from a cache key or value (containers and
    objects' attributes; tensors are skipped)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, bool):
        return
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


def test_no_factor_reaches_the_public_cache(moduli, both_gates):
    from fsdkr_tpu_torch.utils import lru

    both_gates(True)
    lru.clear_caches()
    crt.clear_store()
    n, p, q = moduli[1]
    ctx = crt.get_context(n, p, q)
    secret = {p, q, ctx.d_p, ctx.d_q, ctx.qinv, p * p, q * q, p - 1, q - 1,
              p * (p - 1), q * (q - 1)}
    crt.crt_modexp_batch([_rand_int(700) | 1], [_rand_int(768)], [ctx])
    crt.crt_powm_shared(pow(_rand_int(700), 2, n), [_rand_int(768) for _ in range(4)], ctx)
    crt.fault_checked_powm(_rand_int(500) | 1, p - 1, p * p)
    NiCorrectKeyProof.proof_batch(
        [paillier.DecryptionKey(p=p, q=q)], rounds=2,
        powm=lambda b, e, m: device_powm_grouped(b, e, m, device="cpu"))
    # a public column through the device route on the CPU fills the cache
    device_powm_grouped([3, 5], [_rand_int(64), _rand_int(64)], [n, n], device="cpu")
    cache = lru.global_cache()
    assert cache.stats()["entries"] >= 1
    for key, value in list(cache._d.items()):
        leaked = secret & (set(_ints(key)) | set(_ints(value)))
        assert not leaked, f"a factorization-derived integer in cache entry {key!r}"
    assert crt.store_stats()["entries"] >= 1
    crt.clear_store()
    assert crt.store_stats()["entries"] == 0
    assert ctx.p_leg == 0 and ctx.qinv == 0  # wiped, not just dropped
