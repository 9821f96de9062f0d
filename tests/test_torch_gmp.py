"""The port's GMP bridge (fsdkr_tpu_torch/native/gmp.py) against the JAX
package's (fsdkr_tpu/native/gmp.py), CPython pow and math.gcd, and the
host sites routed through it.

- `powm_batch`, plain and secret (mpz_powm_sec where the row allows it),
  on numpy-seeded rows of 64 to 4160 bits with the edge rows (exponent
  0, base 0, base above the modulus, an even modulus, modulus 1, a
  negative exponent): the JAX bridge's values and pow's, at 1 thread and
  at 4. A negative exponent keeps pow's contract, ValueError included.
- `gcd` with and without a PublicOperand, against the JAX bridge and
  math.gcd (the sieve's primorial among the operands; a zero operand,
  on which the JAX bridge's fold divides by zero, against math.gcd).
- The counters stay exact with 16 threads calling at once.
- A libgmp that does not load, or lacks a symbol, raises NativeBuildError.
- `intops.mod_pow` takes GMP at odd moduli of 1024 bits and up (pow
  below), `backend.powm.host_powm` is one GMP batch, `multi_powm` on the
  host takes GMP rows, and
  `share_recovery_check` and `paillier.decrypt` give the JAX package's
  values with their Paillier rows in GMP.
"""

import math
import sys
import threading

import numpy as np
import pytest

from fsdkr_tpu.backend import powm as jpowm
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.core import intops as jintops
from fsdkr_tpu.core import paillier as jpaillier
from fsdkr_tpu.native import gmp as jgmp
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import refresh as jrefresh
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu_torch import native
from fsdkr_tpu_torch.backend import powm
from fsdkr_tpu_torch.carry import from_reference
from fsdkr_tpu_torch.core import intops, paillier, primes
from fsdkr_tpu_torch.native import gmp
from fsdkr_tpu_torch.native._loader import NativeBuildError
from fsdkr_tpu_torch.protocol import refresh

RNG = np.random.default_rng(0x6A9)


def _rand_int(bits):
    words = RNG.integers(0, 1 << 32, size=(bits + 31) // 32, dtype=np.uint64)
    x = 0
    for w in words:
        x = (x << 32) | int(w)
    return (x >> (len(words) * 32 - bits)) | (1 << (bits - 1))


def _rows():
    rows = []
    for mbits, ebits in ((64, 64), (1088, 1088), (2048, 256), (4096, 2048), (4160, 300)):
        for _ in range(3):
            m = _rand_int(mbits) | 1
            rows.append((_rand_int(mbits + 40), _rand_int(ebits), m))
    m = _rand_int(1024) | 1
    rows += [
        (_rand_int(1000), 0, m),        # exponent 0
        (0, _rand_int(900), m),         # base 0
        (m + 5, _rand_int(900), m),     # base above the modulus
        (m - 1, (1 << 1024) - 1, m),    # every exponent bit set
        (_rand_int(900), 77, m << 1),   # an even modulus
        (_rand_int(900), 5, 1),         # modulus 1
        (2, -5, m),                     # negative exponent, a unit base
    ]
    return rows


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("secret", [False, True], ids=["plain", "secret"])
def test_powm_batch_matches_jax_and_pow(threads, secret):
    rows = _rows()
    b, e, m = (list(c) for c in zip(*rows))
    want = [pow(*r) for r in rows]
    native.set_threads(threads)
    try:
        gmp.stats_reset()
        got = gmp.powm_batch(b, e, m, secret=secret)
        st = gmp.stats()
    finally:
        native.set_threads(0)
    assert got == want == jgmp.powm_batch(b, e, m, secret=secret)
    # every row but the negative exponent's ran in GMP; mpz_powm_sec
    # takes the odd-modulus rows with exp > 0
    assert (st["powm_batches"], st["powm_rows"]) == (1, len(rows) - 1)
    sec = sum(x > 0 and n & 1 for _, x, n in rows) if secret else 0
    assert st["powm_sec_rows"] == sec
    assert [gmp.powm(*r, secret=secret) for r in rows] == want
    assert gmp.powm_batch([], [], []) == []
    with pytest.raises(ValueError):
        gmp.powm_batch(b, e[:-1], m)


def test_negative_exponent_keeps_pows_contract():
    p = _rand_int(1100) | 1
    for fn in (gmp.powm, jgmp.powm):
        with pytest.raises(ValueError):  # no inverse: pow's error
            fn(p * 3, -1, p * 9)
    assert gmp.powm(7, -3, p) == pow(7, -3, p) == jgmp.powm(7, -3, p)
    assert gmp.powm_batch([7], [-3], [p], secret=True) == [pow(7, -3, p)]


@pytest.mark.parametrize("threads", [1, 4])
def test_gcd_matches_jax_and_math(threads):
    prim = primes._sieve_for_bits(1024)[0]
    op, jop = gmp.PublicOperand(prim), jgmp.PublicOperand(prim)
    cands = [_rand_int(1024) | 1 for _ in range(40)] + [3 * 5 * 7919, prim, 1, 0, -prim]
    native.set_threads(threads)
    try:
        gmp.stats_reset()
        got = gmp.map_rows(lambda c: gmp.gcd(c, op), cands)
        assert gmp.stats()["gcd_calls"] == len(cands)
    finally:
        native.set_threads(0)
    want = [math.gcd(c, prim) for c in cands]
    assert got == want
    # the JAX bridge's fold divides by a zero operand (SIGFPE): the port
    # answers gcd(0, b) = |b| before the fold
    assert got == [jgmp.gcd(c, jop) if c else prim for c in cands]
    pairs = [(_rand_int(700) * 6, _rand_int(500) * 9), (0, 12), (-35, 21), (5, 0)]
    assert [gmp.gcd(a, b) for a, b in pairs] == [math.gcd(a, b) for a, b in pairs]
    assert [gmp.gcd(a, b) for a, b in pairs] == [jgmp.gcd(a, b) for a, b in pairs]
    assert gmp.PublicOperand(-prim).value == prim


def test_counters_hold_under_threads():
    m = _rand_int(1024) | 1
    per, workers = 40, 16
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        gmp.stats_reset()
        errs = []

        def work(k):
            try:
                for i in range(per):
                    assert gmp.powm(k + 2, i + 1, m) == pow(k + 2, i + 1, m)
                    gmp.gcd(k * 6 + 3, 9)
            except AssertionError as e:
                errs.append(e)

        ts = [threading.Thread(target=work, args=(k,)) for k in range(workers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts) and not errs
    finally:
        sys.setswitchinterval(before)
    st = gmp.stats()
    assert st["powm_rows"] == st["gcd_calls"] == per * workers


def test_missing_library_or_symbol_raises(monkeypatch):
    monkeypatch.setattr(gmp, "_LIB", None)
    monkeypatch.setattr(gmp, "_SONAMES", ("libgmp-not-here.so.99",))
    monkeypatch.setattr(gmp.ctypes.util, "find_library", lambda name: None)
    with pytest.raises(NativeBuildError):
        gmp.powm(3, 5, 7)
    with pytest.raises(NativeBuildError):
        gmp.available()
    monkeypatch.setattr(gmp, "_SONAMES", ("libgmp.so.10",))
    monkeypatch.setattr(gmp, "_SYMBOLS", {**gmp._SYMBOLS, "__gmpz_not_a_symbol": ([], None)})
    with pytest.raises(NativeBuildError):
        gmp.gcd(4, 6)
    monkeypatch.undo()
    assert gmp.available() and gmp.version().count(".") >= 1
    assert "libgmp" in gmp.library_path()


def test_mod_pow_and_host_powm_route_to_gmp():
    m_wide, m_narrow = _rand_int(1024) | 1, _rand_int(1023) | 1
    b, e = _rand_int(1000), _rand_int(1024)
    gmp.stats_reset()
    for m in (m_wide, m_narrow, m_wide << 1):
        assert intops.mod_pow(b, e, m) == pow(b, e, m) == jintops.mod_pow(b, e, m)
    assert gmp.stats()["powm_rows"] == 1  # the odd modulus of 1024 bits only
    assert intops.mod_pow_signed(b, -e, m_wide) == pow(b, -e, m_wide)

    rows = _rows()
    cols = [list(c) for c in zip(*rows)]
    gmp.stats_reset()
    got = powm.host_powm(*cols)
    assert got == [pow(*r) for r in rows] == jpowm.host_powm(*cols)
    assert gmp.stats()["powm_batches"] == 1

    # multi_powm on the host (the RLC bisection's rows): its joint rows'
    # terms are GMP rows, a negative exponent's base inverted first
    bases = [[_rand_int(1000), _rand_int(900), 5], [_rand_int(700), 3]]
    exps = [[_rand_int(1024), _rand_int(256), -7], [_rand_int(300), _rand_int(1024)]]
    mods = [m_wide, m_narrow]
    want = [math.prod(pow(b, e, m) for b, e in zip(bs, es)) % m
            for bs, es, m in zip(bases, exps, mods)]
    gmp.stats_reset()
    assert powm.multi_powm(bases, exps, mods, device=None) == want
    assert gmp.stats()["powm_rows"] == 5
    assert jpowm.multi_powm(bases, exps, mods, device=False) == want


def _det_unit(seed):
    """A deterministic stand-in for intops.sample_unit, the same draws in
    both packages."""
    state = {"x": seed}

    def sample_unit(modulus):
        while True:
            state["x"] = (state["x"] * 6364136223846793005 + 1442695040888963407) % (1 << 64)
            r = pow(state["x"], 17, modulus)
            if r and math.gcd(r, modulus) == 1:
                return r

    return sample_unit


def test_share_recovery_and_decrypt_match_jax(monkeypatch):
    keys = jax_keygen(1, 3, JAX_CONFIG)
    out = JaxRefresh.distribute_batch([(k.i, k) for k in keys], 3, JAX_CONFIG)
    msgs = [m for m, _ in out]
    key = keys[1]
    monkeypatch.setattr(jintops, "sample_unit", _det_unit(11))
    monkeypatch.setattr(intops, "sample_unit", _det_unit(11))
    want = jrefresh.share_recovery_check(msgs, key)
    gmp.stats_reset()
    got = refresh.share_recovery_check(from_reference(msgs), from_reference(key))
    st = gmp.stats()
    assert got[1] == want[1] and [s.to_int() for s in got[2]] == [s.to_int() for s in want[2]]
    # encrypt(0)'s r^n and t+1 homomorphic muls, all mod n^2 (1536 bits)
    assert st["powm_rows"] == key.t + 2 and st["powm_sec_rows"] == 0

    # the receiver's decrypt of the sum: two fault-checked secret legs
    dk = key.paillier_dk
    gmp.stats_reset()
    m = paillier.decrypt(from_reference(dk), got[0], got[1])
    assert m == jpaillier.decrypt(dk, want[0], want[1])
    assert gmp.stats()["powm_sec_rows"] == 2
