"""The port's CIOS engine (fsdkr_tpu_torch.ops.montgomery), its routing
(backend.powm) and the precompute cache (utils.lru) against the JAX
package.

- The plain versions `mont_mul_limbs`, `_modexp_kernel` and
  `_modmul_kernel` against the JAX package's on XLA:CPU at K = 16 and 32
  limbs, on random rows and worst-case rows (x = y = n - 1 with every
  limb of n at 0xFFFF, every exponent bit set, a modulus of 3).
- `batch_mod_inv_grouped` against the JAX package's and pow, with a
  group that is not invertible.
- `device_powm` / `device_modmul` on device="cpu" through both routes
  (RNS and CIOS, forced by the row thresholds) against the JAX package's
  `tpu_powm` / `tpu_modmul` and pow, and at an 8192-bit modulus, past
  the RNS width classes (the port raised ValueError there before the
  CIOS engine).
- `BudgetLRU` eviction and the hit/miss counts of `_row_consts`.
- The kernel wrappers' input checks.

Inputs come from numpy / random with fixed seeds and go to both packages;
every comparison is exact (integers, limbs). The CUDA kernels run only on
the card (chip_smoke.py holds them against these plain versions there).
"""

import contextlib
import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsdkr_tpu.backend import powm as jpowm
from fsdkr_tpu.ops import limbs as jlimbs
from fsdkr_tpu.ops import montgomery as jmont
from fsdkr_tpu_torch.backend import powm
from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels, rns
from fsdkr_tpu_torch.ops.limbs import MontgomeryContext, ints_to_limbs, limbs_to_ints
from fsdkr_tpu_torch.utils import lru


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on small tensors: torch's intra-op thread
    pool only spins there, and under pytest-xdist it would take cores
    from the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(seed, k, rows, worst):
    """(x, y, moduli, exps) for K=k limbs: random rows with a modulus-3
    row, or worst-case rows."""
    rng = random.Random(seed)
    if worst:
        moduli = [(1 << (16 * k)) - 1] * rows
        xs = ys = [m - 1 for m in moduli]
        exps = [(1 << 64) - 1] * rows
    else:
        moduli = [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1)) for _ in range(rows)]
        moduli[1] = 3
        xs = [rng.randrange(m) for m in moduli]
        ys = [rng.randrange(m) for m in moduli]
        exps = [rng.getrandbits(64) for _ in range(rows)]
        exps[2] = 0
    return xs, ys, moduli, exps


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int64))


def _both(k, xs, ys, moduli):
    """The port's and the JAX package's contexts and limb arrays."""
    ctx = MontgomeryContext(moduli, k)
    jctx = jlimbs.MontgomeryContext(moduli, k)
    for name in ("n", "n_prime", "r2", "one_mont"):
        assert np.array_equal(getattr(ctx, name), getattr(jctx, name))
    return ctx, jctx, ints_to_limbs(xs, k), ints_to_limbs(ys, k)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("k", [16, 32])
def test_mont_mul_limbs_matches_reference(k, worst):
    xs, ys, moduli, _ = _rows(k, k, 8, worst)
    ctx, jctx, x, y = _both(k, xs, ys, moduli)
    got = montgomery.mont_mul_limbs(_t(x), _t(y), _t(ctx.n), _t(ctx.n_inv))
    want = jmont.mont_mul_limbs(jnp.asarray(x), jnp.asarray(y), jnp.asarray(jctx.n),
                                jnp.asarray(jctx.n_prime))
    assert np.array_equal(got.numpy(), np.asarray(want))
    r_inv = [pow(1 << (16 * k), -1, m) for m in moduli]
    assert limbs_to_ints(got.numpy()) == [
        a * b * ri % m for a, b, ri, m in zip(xs, ys, r_inv, moduli)]


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("k", [16, 32])
def test_modexp_and_modmul_kernels_match_reference(k, worst):
    xs, ys, moduli, exps = _rows(100 + k, k, 8, worst)
    ctx, jctx, x, y = _both(k, xs, ys, moduli)
    e = ints_to_limbs(exps, 4)
    got = montgomery._modexp_kernel(_t(x), _t(e), _t(ctx.n), _t(ctx.n_inv), _t(ctx.r2),
                                    _t(ctx.one_mont), exp_bits=64)
    want = jmont._modexp_kernel(*map(jnp.asarray, (x, e, jctx.n, jctx.n_prime, jctx.r2,
                                                   jctx.one_mont)), exp_bits=64)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert limbs_to_ints(got.numpy()) == [pow(a, b, m) for a, b, m in zip(xs, exps, moduli)]
    got = montgomery._modmul_kernel(_t(x), _t(y), _t(ctx.n), _t(ctx.n_inv), _t(ctx.r2))
    want = jmont._modmul_kernel(*map(jnp.asarray, (x, y, jctx.n, jctx.n_prime, jctx.r2)))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_batch_inverse_tree_matches_reference_and_pow():
    rng = random.Random(3)
    m1 = rng.getrandbits(256) | 1 | (1 << 255)
    groups = [
        (m1, [rng.randrange(1, m1) for _ in range(5)]),
        (3 * 5 * 7 * 1009, [2, 15, 4, 0, 11]),  # not invertible: row by row
        (2**127 - 1, [rng.randrange(1, 2**127 - 1) for _ in range(9)]),
        (7, [3]),
    ]
    want = [[intinv(v, m) for v in vs] for m, vs in groups]
    got = montgomery.batch_mod_inv_grouped(groups, 16, "cpu")
    assert got == want
    assert got == jmont.batch_mod_inv_grouped(groups, 16)
    assert None in got[1]


def intinv(v, m):
    return pow(v, -1, m) if math.gcd(v, m) == 1 else None


def _powm_rows(seed, bits, rows, exp_bits):
    rng = random.Random(seed)
    moduli = [rng.getrandbits(bits) | 1 | (1 << (bits - 1)) for _ in range(rows)]
    moduli[1] = 3
    bases = [rng.randrange(m) for m in moduli]
    exps = [rng.getrandbits(exp_bits) for _ in range(rows)]
    exps[0] = 0
    return bases, exps, moduli


@pytest.mark.parametrize("route", ["cios", "rns"])
def test_device_routes_match_reference_and_pow(route, monkeypatch):
    """6 rows of 1024-bit moduli (padded to 8): the launch takes the
    CIOS engine, or the RNS route inside `forced_rns_route()`; both
    routes give the reference's integers."""
    bases, exps, moduli = _powm_rows(11, 1024, 6, 128)
    seen = []
    for name in ("rns_modexp", "rns_modmul", "modexp", "modmul"):
        owner = rns if name.startswith("rns") else montgomery.BatchModExp
        raw = getattr(owner, name)

        def spy(*a, _raw=raw, _name=name, **kw):
            seen.append(_name)
            return _raw(*a, **kw)

        monkeypatch.setattr(owner, name, spy)
    want = [pow(b, e, m) for b, e, m in zip(bases, exps, moduli)]
    want_mul = [b * e % m for b, e, m in zip(bases, exps, moduli)]
    with powm.forced_rns_route() if route == "rns" else contextlib.nullcontext():
        assert powm.device_powm(bases, exps, moduli, "cpu") == want
        assert powm.device_modmul(bases, exps, moduli, "cpu") == want_mul
    assert jpowm.tpu_powm(bases, exps, moduli) == want
    assert jpowm.tpu_modmul(bases, exps, moduli) == want_mul
    assert seen == (["rns_modexp", "rns_modmul"] if route == "rns" else ["modexp", "modmul"])


def test_wide_moduli_take_the_cios_engine():
    """Two rows modulo an 8192-bit modulus (K=512), 64-bit exponents:
    past kernel 2's 7168-bit class, where the port used to raise
    ValueError; the JAX package sends these widths to CIOS."""
    bases, exps, moduli = _powm_rows(12, 8192, 2, 64)
    moduli[1] = moduli[0]
    bases[1] = moduli[0] - 1
    want = [pow(b, e, m) for b, e, m in zip(bases, exps, moduli)]
    assert powm._width_class(8192) is None
    assert powm.device_powm(bases, exps, moduli, "cpu") == want
    assert jpowm.tpu_powm(bases, exps, moduli) == want
    want = [b * e % m for b, e, m in zip(bases, exps, moduli)]
    assert powm.device_modmul(bases, exps, moduli, "cpu") == want
    assert jpowm.tpu_modmul(bases, exps, moduli) == want


def test_budget_lru_evicts_oldest_first():
    cache = lru.BudgetLRU(100)
    cache.put("a", 1, 40)
    cache.put("b", 2, 40)
    assert cache.get("a") == 1  # a is now the most recent
    cache.put("c", 3, 40)  # evicts b
    assert cache.get("b") is None and cache.get("c") == 3
    cache.put("big", 4, 101)  # larger than the budget: never cached
    assert cache.peek("big") is None
    assert cache.stats() == {"entries": 2, "bytes": 80, "budget": 100, "hits": 2,
                             "misses": 1, "evictions": 1}


def test_row_consts_hit_the_cache_on_a_second_call(monkeypatch):
    """Each distinct modulus misses once, then hits; the entries hold only
    values derived from the moduli, and equal a cold computation."""
    monkeypatch.setattr(lru, "_GLOBAL", lru.BudgetLRU(1 << 20))
    rb = rns.rns_bases_for_bits(512, 32)
    rng = random.Random(5)
    moduli = [rng.getrandbits(512) | 1 | (1 << 511) for _ in range(3)]
    moduli.append(rb.A_primes[2] * 5)  # shares a channel prime: a host row
    rows = moduli + moduli[:2]
    first = rns._row_consts(rb, rows)
    assert lru.cache_stats()["misses"] == 4 and lru.cache_stats()["hits"] == 0
    second = rns._row_consts(rb, rows)
    assert lru.cache_stats()["misses"] == 4 and lru.cache_stats()["hits"] == 4
    for a, b in zip(first[:2], second[:2]):
        assert np.array_equal(a, b)
    assert first[2:] == second[2:] and first[3] == [3]
    cold = [rns._modulus_consts(rb, n) for n in rows]
    assert np.array_equal(first[0][0], cold[0][0]) and first[2][5] == cold[5][2]
    # keyed by the public moduli alone
    for key in list(lru._GLOBAL._d):
        assert key[0] == "rns-row" and key[3] in set(rows)


def test_kernel_wrappers_check_their_inputs():
    xs, ys, moduli, exps = _rows(1, 4, 3, False)
    ctx = MontgomeryContext(moduli, 4)
    x, y, n, ni, r2, one = (torch.as_tensor(np.asarray(a, np.int32)) for a in (
        ints_to_limbs(xs, 4), ints_to_limbs(ys, 4), ctx.n, ctx.n_inv, ctx.r2,
        ctx.one_mont))
    e = torch.as_tensor(np.asarray(ints_to_limbs(exps, 4), np.int32))
    before = montgomery_kernels.launch_counts()
    out = montgomery_kernels.modexp(x, e, n, ni, r2, one, 64)
    assert limbs_to_ints(out.numpy()) == [pow(a, b, m) for a, b, m in zip(xs, exps, moduli)]
    assert montgomery_kernels.launch_counts() == before  # the plain version ran
    with pytest.raises(TypeError):
        montgomery_kernels.mont_mul(x.long(), y, n, ni)
    with pytest.raises(ValueError):
        montgomery_kernels.mont_mul(x[:, :3].contiguous(), y[:, :3].contiguous(),
                                    n[:, :3].contiguous(), ni[:, :3].contiguous())
    strided = torch.zeros((3, 8), dtype=torch.int32)
    strided[:, ::2] = x
    with pytest.raises(ValueError):
        montgomery_kernels.mont_mul(strided[:, ::2], y, n, ni)
    with pytest.raises(ValueError):
        montgomery_kernels.modexp(x, e, n, ni, r2, one, 66)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            montgomery.batch_modexp([2], [3], [5], 2)  # the card by default
