"""The port's RNS layer (fsdkr_tpu_torch.ops) against the JAX package.

- The plain PyTorch versions of both Hopper kernels against the Pallas
  kernels in interpret mode (fsdkr_tpu.ops.pallas_rns), as
  tests/test_pallas.py runs them: 512-bit class, 8 rows, random and
  worst-case (every residue m-1, every exponent bit set) inputs. The
  arithmetic is exact modular arithmetic on canonical residues, so the
  tolerance is bit-identical residues.
- The port's RNSBases / _prep_consts against the JAX ones, array for
  array, at 1024, 2048 and 4096 bits.
- rns_modexp / rns_modmul (and the device_powm / device_modmul entry
  points) against fsdkr_tpu.ops.rns.rns_modexp (XLA chain) and pow.

Inputs are made with numpy / random from fixed seeds and handed to both
packages. The CUDA kernels themselves run only on the card
(chip_smoke.py holds them against these plain versions there).
"""

import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsdkr_tpu.ops import rns as jrns
from fsdkr_tpu.ops.pallas_rns import rns_mont_mul_pallas, rns_modexp_pallas
from fsdkr_tpu_torch.backend.powm import device_modmul, device_powm
from fsdkr_tpu_torch.ops import rns, rns_kernels

BITS = 512
ROWS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on small tensors: torch's intra-op thread
    pool only spins there, and under pytest-xdist it would take cores
    from the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _moduli(rng, rb, rows, bits):
    prod = rb.A * rb.B * rb.m_r
    out = []
    while len(out) < rows:
        n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if math.gcd(n, prod) == 1:
            out.append(n)
    return out


def _inputs(seed, worst, exp_bits=64):
    """(x, y, c1, nbmr, exp) as numpy int64 arrays for the 512-bit class."""
    rb = rns.rns_bases_for_bits(BITS, BITS // 16)
    k = rb.k
    m = rb.m_all.astype(np.int64)
    nrng = np.random.default_rng(seed)
    c1, nb, _, _ = rns._row_consts(rb, _moduli(random.Random(seed), rb, ROWS, BITS))
    if worst:
        x = np.tile(m - 1, (ROWS, 1))
        y = x.copy()
        c1 = np.tile(m[:k] - 1, (ROWS, 1))
        nb = np.tile(m[k:] - 1, (ROWS, 1))
        exp = np.full((ROWS, exp_bits // 16), 0xFFFF, np.int64)
    else:
        x = nrng.integers(0, m, size=(ROWS, 2 * k + 1))
        y = nrng.integers(0, m, size=(ROWS, 2 * k + 1))
        exp = nrng.integers(0, 1 << 16, size=(ROWS, exp_bits // 16))
    return rb, x, y, np.asarray(c1, np.int64), np.asarray(nb, np.int64), exp


def _torch(*arrays):
    return [torch.as_tensor(np.asarray(a, np.int32)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(np.asarray(a, np.uint32)) for a in arrays]


def _port_consts(rb):
    return rns._device_consts(rb, torch.device("cpu")).kernel


def _pallas_shared(bits):
    jrb = jrns.rns_bases_for_bits(bits, bits // 16)
    return jrns._pallas_shared(jrns._prep_consts(jrb))


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
def test_mont_mul_plain_matches_pallas(worst):
    rb, x, y, c1, nb, _ = _inputs(11, worst)
    want = np.asarray(
        rns_mont_mul_pallas(
            *_jax(x, y, c1, nb), _pallas_shared(BITS), k=rb.k, interpret=True
        )
    )
    tx, ty, tc1, tnb = _torch(x, y, c1, nb)
    got = rns_kernels.mont_mul(tx, ty, tc1, tnb, _port_consts(rb)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
def test_modexp_plain_matches_pallas(worst):
    exp_bits = 64
    rb, x, y, c1, nb, exp = _inputs(12, worst, exp_bits)
    want = np.asarray(
        rns_modexp_pallas(
            *_jax(x, exp, y, c1, nb), _pallas_shared(BITS),
            exp_bits=exp_bits, k=rb.k, interpret=True,
        )
    )
    tx, texp, ty, tc1, tnb = _torch(x, exp, y, c1, nb)
    got = rns_kernels.modexp(
        tx, texp, ty, tc1, tnb, _port_consts(rb), exp_bits
    ).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_wrappers_check_their_inputs():
    rb, x, y, c1, nb, exp = _inputs(13, False)
    tx, ty, tc1, tnb, texp = _torch(x, y, c1, nb, exp)
    K = _port_consts(rb)
    with pytest.raises(TypeError):
        rns_kernels.mont_mul(tx.to(torch.int64), ty, tc1, tnb, K)
    with pytest.raises(ValueError):
        rns_kernels.mont_mul(tx[:, :-1].contiguous(), ty, tc1, tnb, K)
    with pytest.raises(ValueError):
        rns_kernels.modexp(tx, texp, ty, tc1, tnb, K, 128)  # limbs hold 64 bits
    before = rns_kernels.launch_counts()
    rns_kernels.mont_mul(tx, ty, tc1, tnb, K)
    assert rns_kernels.launch_counts() == before  # the plain path is no launch


@pytest.mark.parametrize("bits", [1024, 2048, 4096])
def test_constants_equal_reference(bits):
    """The RNS constants are the weights of this system: the port computes
    its own and they must equal the JAX package's, array for array."""
    j = jrns.rns_bases_for_bits(bits, bits // 16)
    p = rns.rns_bases_for_bits(bits, bits // 16)
    assert (p.k, p.A_primes, p.B_primes, p.m_r, p.A, p.B) == (
        j.k, j.A_primes, j.B_primes, j.m_r, j.A, j.B
    )
    for name in ("Ai_inv", "c2_B", "T1", "T2", "Ainv_B", "B_mod_A", "mA",
                 "mB", "m_all", "Wconv"):
        np.testing.assert_array_equal(getattr(p, name), getattr(j, name), name)
    assert int(p.Binv_r) == int(j.Binv_r)

    # _prep_consts: JAX splits T1/T2/W into bf16 8-bit halves for the MXU,
    # the port keeps the full 16-bit values
    (m_all, _u, T1l, T1h, T2l, T2h, ainv, c2, bmoda, binvr, Wl, Wh) = (
        jrns._prep_consts(j)
    )

    def joined(lo, hi):
        lo = np.asarray(lo.astype(jnp.float32)).astype(np.int64)
        hi = np.asarray(hi.astype(jnp.float32)).astype(np.int64)
        return lo + 256 * hi

    K = rns._prep_consts(p, torch.device("cpu"))
    assert K.k == j.k
    np.testing.assert_array_equal(K.m_all.numpy(), np.asarray(m_all))
    np.testing.assert_array_equal(K.T1.numpy(), joined(T1l, T1h))
    np.testing.assert_array_equal(K.T2.numpy(), joined(T2l, T2h))
    np.testing.assert_array_equal(K.Ainv_B.numpy(), np.asarray(ainv))
    np.testing.assert_array_equal(K.c2_B.numpy(), np.asarray(c2))
    np.testing.assert_array_equal(K.B_mod_A.numpy(), np.asarray(bmoda))
    assert K.Binv_r == int(binvr)
    np.testing.assert_array_equal(p.Wconv, joined(Wl, Wh))

    # the CRT-exit constants
    jec = j.exit_consts
    pec = p.exit_arrays()
    np.testing.assert_array_equal(pec[0], np.asarray(jec[0]))
    np.testing.assert_array_equal(pec[1], np.asarray(jec[1]))
    assert pec[2] == int(jec[2])
    np.testing.assert_array_equal(pec[3], np.asarray(jec[3]))
    np.testing.assert_array_equal(pec[4], np.asarray(jec[4]))
    assert pec[5] == jec[7]


def _rows(seed, bits, rows=6):
    """Random rows plus the edge cases: exponent 0, an all-ones exponent,
    and a modulus that shares an A channel prime (host-evaluated row)."""
    rng = random.Random(seed)
    moduli = [rng.getrandbits(bits) | (1 << (bits - 1)) | 1 for _ in range(rows)]
    rb = rns.rns_bases_for_bits(bits, bits // 16)
    moduli[2] = rb.A_primes[5] * (rng.getrandbits(bits - 17) | 1 | (1 << (bits - 18)))
    bases = [rng.randrange(n) for n in moduli]
    exps = [rng.getrandbits(256) for _ in range(rows)]
    exps[0] = 0
    exps[1] = (1 << 256) - 1
    return bases, exps, moduli


@pytest.mark.parametrize("bits", [512, 1024, 1536])
def test_rns_modexp_matches_reference_and_pow(bits):
    bases, exps, moduli = _rows(bits, bits)
    want = [pow(b, e, n) for b, e, n in zip(bases, exps, moduli)]
    got = rns.rns_modexp(bases, exps, moduli, bits, "cpu")
    assert got == want
    assert got == jrns.rns_modexp(bases, exps, moduli, bits)
    # the entry point: 6 rows padded to 8 with modulus-3 rows, class chosen
    # from the widest modulus
    assert device_powm(bases, exps, moduli, "cpu") == want


@pytest.mark.parametrize("bits", [512, 1024, 1536])
def test_rns_modmul_matches_pow(bits):
    a, b, moduli = _rows(bits + 1, bits)
    b = [x % n for x, n in zip(b, moduli)]
    want = [x * y % n for x, y, n in zip(a, b, moduli)]
    assert rns.rns_modmul(a, b, moduli, bits, "cpu") == want
    assert device_modmul(a, b, moduli, "cpu") == want


def test_device_route_needs_a_card():
    """No host fallback: a CUDA device that is not there raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        device_powm([2], [3], [5], "cuda")
    # the ops entry points default to the card as well
    with pytest.raises((RuntimeError, AssertionError)):
        rns.rns_modexp([2], [3], [5], 256)
    with pytest.raises((RuntimeError, AssertionError)):
        rns.rns_modmul([2], [3], [5], 256)


def _limb_value(row):
    return sum(int(v) << (16 * i) for i, v in enumerate(row))


def test_normalize_carries_in_place_matches_int_arithmetic():
    """Signed delayed-carry limbs (sums up to 2^41, borrows of -1) are
    normalized in place to the canonical limbs of the same integer."""
    nrng = np.random.default_rng(7)
    a = nrng.integers(0, 1 << 41, size=(6, 12))
    b = nrng.integers(0, 1 << 16, size=(6, 12))
    a[:, -2:] = 0
    b[:, -3:] = 0
    a[:, -3] = 1 << 20  # a > b row-wise
    want = [_limb_value(x) - _limb_value(y) for x, y in zip(a, b)]
    t = torch.as_tensor(a)
    out = rns._sub_limbs(t, torch.as_tensor(b))
    assert out.data_ptr() == t.data_ptr()
    assert int(out.min()) >= 0 and int(out.max()) < 1 << 16
    assert [_limb_value(r) for r in out.tolist()] == want


@pytest.mark.parametrize("bits", [512, 1536])
def test_crt_exit_recovers_the_value(bits):
    """The device CRT exit turns the residues of a value v < A (random
    values, and the largest, A - 1) into the exact limbs of v."""
    rb = rns.rns_bases_for_bits(bits, bits // 16)
    rng = random.Random(bits)
    values = [rng.randrange(rb.A) for _ in range(4)] + [rb.A - 1]
    res = [[v % int(p) for p in rb.m_all] for v in values]
    dc = rns._device_consts(rb, torch.device("cpu"))
    got = rns._crt_exit_kernel(torch.as_tensor(res, dtype=torch.int32), dc)
    assert [_limb_value(r) for r in got.tolist()] == values
