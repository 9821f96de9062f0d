"""The joint (Straus) and shared-exponent modexp of the port
(ops.montgomery `multi_modexp` / `shared_exp_batches` and their plain
versions `_multi_modexp_kernel` / `_shared_exp_kernel`) and the routing
built on them (backend.powm: `multi_powm`, `batch_base_inv`,
`device_powm_shared_exp`, `joint_comb2`, `fold_ladder2` and the joint
columns of `powm_columns`), on device="cpu", against the JAX package on
XLA:CPU (its device routes forced on by tests/conftest.py) and CPython
pow.

- The plain Straus product at T = 2, 3 and 5 terms (5: where the JAX
  package folds the selected entries in a tree) with mixed widths given
  out of order, zero exponents, bases at or above the modulus and padding
  rows (base 1, exponent 0, modulus 3).
- The plain shared-exponent product over two segments of one call, each
  with its own modulus and exponent (one of them 0).
- multi_powm with negative exponents, comb-routed shared bases (the JAX
  package's grouping rule, 4 rows), an 18-term row split at the device's
  term cap, rows of 1, 2 and 3 terms in one call; a non-invertible base
  under a negative exponent raises ValueError in both packages.
- batch_base_inv with a group poisoned by a value that has no inverse.
- device_powm_shared_exp with and without its aux term, over several
  groups in one call, and joint_comb2, against tpu_powm_shared_exp and
  joint_comb2; fold_ladder2 against pow.
- powm_columns over scalar and joint columns with an aliased duplicate.
- The wrappers' input checks, and the term cap's split.

Every comparison is exact. The kernels themselves are held against these
plain versions on the card by chip_smoke.py.
"""

import random
from functools import partial

import pytest
import torch

from fsdkr_tpu.backend import powm as jpowm
from fsdkr_tpu.ops import montgomery as jmont
from fsdkr_tpu_torch.backend import powm
from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels
from fsdkr_tpu_torch.ops.limbs import bucket_exp_bits, limbs_for_bits
from fsdkr_tpu_torch.utils import lru

SEED = 0x5715


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on small tensors: torch's intra-op thread
    pool only spins there, and under pytest-xdist it would take cores
    from the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _own_cache(monkeypatch):
    """A fresh precompute cache per test, and the JAX package's grouping
    rule (4 rows), so that a small group takes the comb as in the
    reference."""
    monkeypatch.setattr(lru, "_GLOBAL", lru.BudgetLRU(1 << 24))
    monkeypatch.setattr(powm, "_SHARED_MIN_ROWS", jpowm._SHARED_MIN_ROWS)


def _odd(rng, bits):
    return rng.getrandbits(bits) | 1 | (1 << (bits - 1))


def _oracle(bases_rows, exps_rows, moduli):
    out = []
    for bs, es, m in zip(bases_rows, exps_rows, moduli):
        acc = 1 % m
        for b, e in zip(bs, es):
            acc = acc * pow(b, e, m) % m
        out.append(acc)
    return out


# (modulus bits, each term's exponent bits, given out of width order)
STRAUS_CASES = {
    "t2": (768, (256, 768)),
    "t3": (256, (128, 256, 64)),
    "t5_tree": (256, (128, 256, 64, 256, 64)),
}


@pytest.mark.parametrize("case", sorted(STRAUS_CASES))
def test_plain_multi_modexp_matches_jax_and_pow(case):
    bits, widths = STRAUS_CASES[case]
    rng = random.Random(f"{SEED}{case}")
    rows = 8
    moduli = [_odd(rng, bits) for _ in range(rows - 2)] + [3, 3]
    # a base at or above its modulus, a zero exponent; two padding rows
    bases = [tuple(rng.randrange(2 * m) for _ in widths) for m in moduli[:-2]]
    bases[0] = (moduli[0] + 5,) + bases[0][1:]
    exps = [tuple(rng.getrandbits(w) for w in widths) for _ in moduli[:-2]]
    exps[1] = (0,) + exps[1][1:]
    bases += [(1,) * len(widths)] * 2
    exps += [(0,) * len(widths)] * 2
    eb = [bucket_exp_bits([e[t] for e in exps]) for t in range(len(widths))]
    k = limbs_for_bits(bits)
    got = montgomery.multi_modexp(bases, exps, moduli, k, eb, device="cpu")
    assert got == _oracle(bases, exps, moduli)
    assert got == jmont.multi_modexp(bases, exps, moduli, k, eb)


def test_plain_shared_exp_matches_jax():
    rng = random.Random(SEED)
    m1, m2 = _odd(rng, 512), _odd(rng, 256)
    e1 = rng.getrandbits(512)
    b1 = [rng.randrange(m1) for _ in range(7)] + [m1 + 3]
    b2 = [rng.randrange(m2) for _ in range(8)]
    ctx1 = montgomery.BatchModExp([m1], limbs_for_bits(512), "cpu")
    ctx2 = montgomery.BatchModExp([m2], limbs_for_bits(256), "cpu")
    got = montgomery.shared_exp_batches([(ctx1, b1, e1), (ctx2, b2, 0)])
    assert got == [[pow(b, e1, m1) for b in b1], [1] * 8]
    assert got[0] == jmont.shared_exp_modexp(b1, e1, m1, limbs_for_bits(512))
    assert montgomery.exp_digits(0xA5, 8) == [0xA, 0x5]


def _planner_rows(rng):
    """multi_powm rows at 256-bit moduli: 6 rows sharing h (a comb group
    under the 4-row rule) beside a per-row base with a negative exponent;
    an 18-term row (split at the device's 16-term cap) and two 3-term
    rows; a 1-term row."""
    m1, m2 = _odd(rng, 256), _odd(rng, 256)
    h = rng.randrange(m1)
    rows_b, rows_e, mods = [], [], []
    for _ in range(6):
        rows_b.append((h, rng.randrange(1, m1)))
        rows_e.append((rng.getrandbits(64), -rng.getrandbits(128)))
        mods.append(m1)
    for terms in (18, 3, 3):
        rows_b.append(tuple(rng.randrange(m2) for _ in range(terms)))
        rows_e.append(tuple(rng.getrandbits(64) for _ in range(terms)))
        mods.append(m2)
    rows_b.append((rng.randrange(m2),))
    rows_e.append((rng.getrandbits(128),))
    mods.append(m2)
    return rows_b, rows_e, mods


def test_multi_powm_matches_jax_and_pow(monkeypatch):
    rows_b, rows_e, mods = _planner_rows(random.Random(SEED + 1))
    want = []
    for bs, es, m in zip(rows_b, rows_e, mods):
        acc = 1
        for b, e in zip(bs, es):
            acc = acc * (pow(b, e, m) if e >= 0 else pow(pow(b, -1, m), -e, m)) % m
        want.append(acc)
    shared, launches = [], []
    raw_shared, raw_joint = powm.device_powm_shared, powm._device_joint_launch
    monkeypatch.setattr(powm, "device_powm_shared",
                        lambda *a, **kw: shared.append(len(a[0])) or raw_shared(*a, **kw))
    monkeypatch.setattr(powm, "_device_joint_launch",
                        lambda b, e, m, t, d: launches.append((t, len(m))) or raw_joint(b, e, m, t, d))
    assert powm.multi_powm(rows_b, rows_e, mods, "cpu") == want
    assert shared == [1]  # h's group of 6
    # the 18-term row as 16 + 2 terms beside the two 3-term rows
    assert sorted(launches) == [(2, 1), (3, 2), (16, 1)]
    assert powm.multi_powm(rows_b, rows_e, mods, None) == want
    assert jpowm.multi_powm(rows_b, rows_e, mods, device=True) == want

    # a negative exponent on a base with no inverse raises in both
    bad_b, bad_e, bad_m = [(3, 2)], [(-5, 1)], [15]
    with pytest.raises(ValueError):
        powm.multi_powm(bad_b, bad_e, bad_m, "cpu")
    with pytest.raises(ValueError):
        jpowm.multi_powm(bad_b, bad_e, bad_m, device=True)


def test_batch_base_inv_matches_reference():
    p, q = 1009, 2**61 - 1
    values = [2, 15, 1009 * 7, 4, 11, 5, q - 2, 0, 3]
    moduli = [p * 3, p * 3, p * 3, p * 3, q, q, q, q, 7]
    got = powm.batch_base_inv(values, moduli)
    assert got == jpowm.batch_base_inv(values, moduli)
    for v, m, inv in zip(values, moduli, got):
        if inv is None:
            with pytest.raises(ValueError):
                pow(v, -1, m)
        else:
            assert inv * v % m == 1
    assert None in got and got.count(None) < len(got)


def test_shared_exp_and_comb2_match_jax():
    rng = random.Random(SEED + 2)
    m = _odd(rng, 256)
    n = rng.getrandbits(256)
    bases = [rng.randrange(m) for _ in range(6)]
    aux_b = [rng.randrange(m) for _ in range(6)]
    aux_e = [rng.getrandbits(64) for _ in range(6)]
    want = [pow(b, n, m) * pow(a, e, m) % m for b, a, e in zip(bases, aux_b, aux_e)]
    got = powm.device_powm_shared_exp(bases, n, m, aux_b, aux_e, device="cpu")
    assert got == want == jpowm.tpu_powm_shared_exp(bases, n, m, aux_b, aux_e)
    assert powm.device_powm_shared_exp(bases, n, m, device="cpu") == [pow(b, n, m) for b in bases]
    # three groups in one call (one launch): their own moduli and exponents
    m2 = _odd(rng, 512)
    n2 = rng.getrandbits(500)
    b2 = [rng.randrange(m2) for _ in range(3)]
    groups = [(bases, n, m, aux_b, aux_e), (b2, n2, m2, None, None), ([], 7, m, None, None)]
    assert powm.device_powm_shared_exp_groups(groups, "cpu") == [
        want, [pow(b, n2, m2) for b in b2], []]

    h1, h2 = rng.randrange(m), rng.randrange(m)
    e1 = [rng.getrandbits(64) for _ in range(5)]
    e2 = [rng.getrandbits(192) for _ in range(5)]
    want2 = [pow(h1, a, m) * pow(h2, b, m) % m for a, b in zip(e1, e2)]
    assert powm.joint_comb2(h1, e1, h2, e2, m, device="cpu") == want2
    assert jpowm.joint_comb2(h1, e1, h2, e2, m) == want2
    with pytest.raises(ValueError):
        powm.joint_comb2(h1, e1, h2, e2[:-1], m, device="cpu")
    rows = [((h1, h2), (a, b), m) for a, b in zip(e1, e2)]
    assert powm.fold_ladder2(rows, "cpu") == want2 == powm.fold_ladder2(rows, None)


def test_powm_columns_pools_joint_columns_like_reference():
    rng = random.Random(SEED + 3)
    ms = [_odd(rng, 256) for _ in range(5)]
    scalar = ([rng.randrange(m) for m in ms], [rng.getrandbits(128) for _ in ms], ms)
    joint = ([(rng.randrange(m), rng.randrange(m)) for m in ms],
             [(rng.getrandbits(256), rng.getrandbits(64)) for _ in ms], ms)
    joint3 = ([(rng.randrange(m),) * 3 for m in ms[:3]],
              [(rng.getrandbits(64), 0, rng.getrandbits(64)) for _ in range(3)], ms[:3])
    dup = tuple(list(col) for col in joint)  # equal, not the same lists
    cols = (scalar, joint, joint3, dup)
    want = [[pow(b, e, m) for b, e, m in zip(*scalar)],
            _oracle(*joint), _oracle(*joint3), _oracle(*joint)]
    got = powm.powm_columns(partial(powm.device_powm_grouped, device="cpu"), *cols)
    assert got == want
    assert got[3] is not got[1]
    assert powm.powm_columns(powm.host_powm, *cols) == want
    assert jpowm.powm_columns(jpowm.tpu_powm_grouped, *cols) == want


def test_wrappers_check_inputs_and_term_cap():
    k = 16
    n = torch.zeros((2, k), dtype=torch.int32)
    bases = torch.zeros((2, 2, k), dtype=torch.int32)
    exps = torch.zeros((2, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="descending"):
        montgomery_kernels.multi_modexp(bases, exps, n, n, n, n, (32, 64))
    with pytest.raises(ValueError, match="terms"):
        montgomery_kernels.multi_modexp(bases, exps, n, n, n, n, (64,))
    with pytest.raises(ValueError, match="exp_bits"):
        montgomery_kernels.multi_modexp(bases, exps, n, n, n, n, (128, 64))
    with pytest.raises(TypeError):
        montgomery_kernels.multi_modexp(bases.to(torch.int64), exps, n, n, n, n, (64, 64))
    one = torch.zeros((1, k), dtype=torch.int32)
    digits = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        montgomery_kernels.shared_exp_segments([(n, digits, n, n, n, n)])
    with pytest.raises(ValueError, match="segments"):
        montgomery_kernels.shared_exp_segments([])
    with pytest.raises(ValueError, match="windows"):
        montgomery_kernels.shared_exp_segments([(n, digits[None], one, one, one, one)])
    # one warp's tables in a block's shared memory: 16 terms up to K=256,
    # 14 at K=512, 7 at K=1024; the planner splits rows at that cap
    assert [montgomery_kernels.multi_modexp_max_terms(k) for k in (16, 128, 256, 512, 1024)] == [
        16, 16, 16, 14, 7]
    assert [powm._term_cap(1 << (b - 1)) for b in (2048, 4096, 8192, 16384)] == [16, 16, 14, 7]
    # CPU calls run the plain versions and launch nothing
    before = montgomery_kernels.launch_counts()
    assert powm.multi_powm([(2, 3)], [(5, 7)], [1009], "cpu") == [pow(2, 5, 1009) * pow(3, 7, 1009) % 1009]
    assert powm.device_powm_shared_exp([2, 3], 9, 1009, device="cpu") == [pow(2, 9, 1009), pow(3, 9, 1009)]
    assert montgomery_kernels.launch_counts() == before
