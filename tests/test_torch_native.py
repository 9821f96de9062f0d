"""The port's native host core (fsdkr_tpu_torch/native, built from
fsdkr_tpu_torch/csrc/fsdkr_native.cpp with g++) against CPython and the
JAX package's bridge, at 512-1024 bits.

- The Miller-Rabin batch agrees with a CPython Miller-Rabin oracle
  (`_mr_rounds` below) and with the JAX package's
  `is_probable_prime_batch` on primes, composites, prime products and
  Carmichael numbers.
- The CRT leg batch and the one-shot comb agree with pow, at any thread
  count.
- The windowed prime pipeline yields primes of the asked width with the
  top two bits set, its sieve and Miller-Rabin rounds through GMP
  (native/gmp.py).
- The Montgomery product runs on libgmp's mpn functions ("mpn"), and
  gives the portable loop's bits (`set_mpn(0)`) and the JAX core's.
- A failed build raises, and so does an input outside the core's range
  (no silent CPython path); the widest CRT leg the protocol makes (p^2 r
  at 8192-bit Paillier) is inside it.
"""

import random
import secrets

import numpy as np
import pytest

from fsdkr_tpu import native as jnative
from fsdkr_tpu_torch import native
from fsdkr_tpu_torch.core import primes
from fsdkr_tpu_torch.native import gmp
from fsdkr_tpu_torch.native._loader import NativeBuildError, NativeLib

RNG = np.random.default_rng(0x5EED)


def _rand_int(bits):
    """A numpy-seeded integer of exactly `bits` bits."""
    words = RNG.integers(0, 1 << 32, size=(bits + 31) // 32, dtype=np.uint64)
    x = 0
    for w in words:
        x = (x << 32) | int(w)
    return (x >> (len(words) * 32 - bits)) | (1 << (bits - 1))


def _mr_rounds(n, rounds):
    """Miller-Rabin rounds with CSPRNG witnesses over CPython pow."""
    d = n - 1
    r = (d & -d).bit_length() - 1
    d >>= r
    for _ in range(rounds):
        a = 2 + secrets.randbelow(n - 3)
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _next_prime(x):
    c = x | 1
    while not _mr_rounds(c, 20) or any(c % s == 0 for s in (3, 5, 7)):
        c += 2
    return c


@pytest.fixture(scope="module")
def prime_pool():
    return [_next_prime(_rand_int(b)) for b in (256, 384, 512, 512)]


def _candidates(prime_pool):
    p1, p2, p3, p4 = prime_pool
    carmichael = [561, 41041, 825265, 321197185, 5394826801, 232250619601,
                  9746347772161]
    odd_composites = [(_rand_int(512) | 1) for _ in range(6)]
    return (
        [p1, p2, p3, p4, p1 * p2, p3 * p4, p3 * p3, (1 << 521) - 1]
        + carmichael + odd_composites
    )


def test_native_core_builds_and_loads():
    assert native.available()
    assert native.LIB.loaded()
    assert native.thread_count() >= 1


def test_mr_batch_agrees_with_oracle_and_jax(prime_pool):
    cands = _candidates(prime_pool)
    got = native.is_probable_prime_batch(cands, 30)
    oracle = [_mr_rounds(c, 30) for c in cands]
    assert got == oracle
    jax_got = jnative.is_probable_prime_batch(cands, 30)
    if jax_got is None:  # the JAX package's core did not build here
        jax_got = [jnative.is_probable_prime(c, 30) for c in cands]
    assert got == jax_got
    assert got[:4] == [True] * 4 and not any(got[4:7])


def test_mr_single_and_out_of_range(prime_pool):
    p = prime_pool[2]
    assert native.is_probable_prime(p) is True
    assert native.is_probable_prime(p * prime_pool[3]) is False
    with pytest.raises(ValueError):
        native.is_probable_prime(4)  # even: the caller's case
    with pytest.raises(ValueError):
        native.is_probable_prime_batch([p, 10])
    wide = (1 << 8400) + 1
    with pytest.raises(ValueError):
        native.is_probable_prime(wide)  # wider than the core
    with pytest.raises(ValueError):
        primes.is_probable_prime(wide)  # no CPython path behind it
    assert primes.is_probable_prime(p) and not primes.is_probable_prime(p * 3)


@pytest.mark.parametrize("threads", [1, 0])
def test_crt_leg_batch_matches_pow(prime_pool, threads):
    native.set_threads(threads)
    try:
        rows = []
        for bits in (512, 768, 1024):
            m = _rand_int(bits) | 1
            # a run of equal consecutive moduli, then a lone one
            for _ in range(3):
                rows.append((_rand_int(bits + 64) % m, _rand_int(bits), m))
        rows.append((5, 0, prime_pool[0]))  # exponent 0
        rows.append((0, 7, prime_pool[1]))  # base 0
        b, e, m = zip(*rows)
        assert native.crt_modexp_batch(b, e, m) == [pow(*r) for r in rows]
        # the widest leg: p^2 r at 8192-bit Paillier, 8256 bits
        m = _rand_int(8256) | 1
        row = (_rand_int(8000), _rand_int(4096), m)
        assert native.crt_modexp_batch(*([x] for x in row)) == [pow(*row)]
        assert native.modexp_shared(row[0], [row[1], 5], m) == [pow(*row), pow(row[0], 5, m)]
        # outside the core: an even or too wide modulus, a negative exponent
        for b, e, m in ((3, 5, 1 << 100), (3, -5, 7), (3, 5, (1 << 8400) + 1)):
            with pytest.raises(ValueError):
                native.crt_modexp_batch([b], [e], [m])
            with pytest.raises(ValueError):
                native.modexp_shared(b, [e], m)
    finally:
        native.set_threads(0)


def test_comb_matches_pow(prime_pool):
    n = prime_pool[2] * prime_pool[3]
    base = _rand_int(900) % n
    exps = [0, 1, n - 1] + [_rand_int(1024) for _ in range(13)]
    assert native.modexp_shared(base, exps, n) == [pow(base, e, n) for e in exps]
    assert native.modexp_shared(base, [], n) == []


def test_windowed_pipeline_widths_and_native_batches():
    gmp.stats_reset()
    primes.gen_stats_reset()
    ps = primes.gen_primes_batch(512, 3)
    assert len(ps) == 3
    for p in ps:
        assert p.bit_length() == 512 and p >> 510 == 3
        assert _mr_rounds(p, 20)
    st, gen = gmp.stats(), primes.gen_stats()
    # every sieved candidate a GMP gcd, every Miller-Rabin round a GMP powm
    assert st["gcd_calls"] >= gen["candidates"] >= 3
    assert st["powm_rows"] == gen["mr_rounds"] >= 3 + 29 * 3
    for n, p, q in primes.gen_moduli_batch(1024, 2):
        assert n == p * q and p != q and n.bit_length() == 1024


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    lib = NativeLib(src, {"fsdkr_set_threads": ()})
    monkeypatch.setattr("fsdkr_tpu_torch.native._loader._BUILD", tmp_path / "build")
    with pytest.raises(NativeBuildError):
        lib.get()
    good = tmp_path / "ok.cpp"
    good.write_text('extern "C" int f(void) { return 7; }\n')
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(NativeBuildError):
        NativeLib(good, {"f": ()}).get()
    monkeypatch.delenv("CXX")
    with pytest.raises(NativeBuildError):  # a symbol the library lacks
        NativeLib(good, {"g": ()}).get()
    assert NativeLib(good, {"f": ()}).get().f() == 7


def test_python_oracle_agrees_on_small_primes():
    rng = random.Random(7)
    small = [rng.randrange(5, 1 << 40) | 1 for _ in range(64)]
    got = native.is_probable_prime_batch(small, 20)
    assert got == [_mr_rounds(c, 20) for c in small]


def test_engine_is_mpn_and_portable_is_a_hook():
    assert native.engine_kind() == "mpn"
    try:
        assert native.set_mpn(0) == "portable" == native.engine_kind()
    finally:
        assert native.set_mpn(1) == "mpn"


@pytest.mark.parametrize("threads", [1, 3])
def test_mpn_core_matches_portable_and_jax(prime_pool, threads):
    """The CRT leg batch, the comb and Miller-Rabin on the mpn engine
    against the portable loop (set_mpn(0)), the JAX core and pow, at
    1 to 64 limbs (the JAX core's widest) and at 8256 bits (the port's
    widest leg)."""
    rows = []
    for bits in (64, 520, 1088, 2048, 4096):
        m = _rand_int(bits) | 1
        for _ in range(3):
            rows.append((_rand_int(bits + 64) % m, _rand_int(bits), m))
        rows.append((m - 1, (1 << bits) - 1, m))  # every exponent bit set
    b, e, m = (list(c) for c in zip(*rows))
    wide = (_rand_int(8000), _rand_int(4096), _rand_int(8256) | 1)
    cands = _candidates(prime_pool)
    native.set_threads(threads)
    try:
        got = native.crt_modexp_batch(b, e, m)
        comb = native.modexp_shared(b[5], e[4:8], m[5])
        got_wide = native.crt_modexp_batch(*([x] for x in wide))
        mr = native.is_probable_prime_batch(cands, 30)
        native.set_mpn(0)
        assert native.crt_modexp_batch(b, e, m) == got
        assert native.modexp_shared(b[5], e[4:8], m[5]) == comb
        assert native.crt_modexp_batch(*([x] for x in wide)) == got_wide
        assert native.is_probable_prime_batch(cands, 30) == mr
    finally:
        native.set_mpn(1)
        native.set_threads(0)
    assert got == [pow(*r) for r in rows] == jnative.crt_modexp_batch(b, e, m)
    assert comb == [pow(b[5], x, m[5]) for x in e[4:8]]
    assert got_wide == [pow(*wide)]
    assert mr == [_mr_rounds(c, 30) for c in cands]
