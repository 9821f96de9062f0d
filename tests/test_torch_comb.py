"""The port's fixed-base comb (fsdkr_tpu_torch.ops.montgomery
.shared_base_modexp) and its grouped routing (backend.powm
.device_powm_shared / device_powm_grouped) against the JAX package.

- `shared_base_modexp` against the JAX package's on XLA:CPU (its ladder
  on the device, the port's only ladder), with unequal group sizes, an
  odd limb count (K=9: the port's engine rounds it up to 10), a zero
  exponent and a worst-case group (every limb of n at 0xFFFF, the base
  n - 1, every exponent bit set).
- The ladder's plain version against CPython pow: powers[w] =
  base^(16^w) * R mod n.
- `device_powm_shared` / `device_powm_grouped` against `tpu_powm_shared`
  / `tpu_powm_grouped` on a column of comb groups and loners, with the
  row-axis and group-axis tiling forced by a small `_MAX_ROWS`.
- The comb's Montgomery contexts in the precompute cache: cold and warm
  calls agree, hits rise, and no entry is shared by two modulus vectors.
- Inside `forced_rns_route()`, `device_powm_grouped` launches no comb
  (counted by stand-ins for the kernel wrappers).
- The comb wrappers' input checks.

The port runs on device="cpu" (its kernels' plain versions). Inputs come
from seeded generators and go to both packages; every comparison is
exact. The JAX package's comb compiles at one shape here: (8 groups, 16
rows), the powers computed on the device.
"""

import contextlib
import random

import pytest
import torch

from fsdkr_tpu.backend import powm as jpowm
from fsdkr_tpu.ops import montgomery as jmont
from fsdkr_tpu_torch.backend import powm
from fsdkr_tpu_torch.ops import limbs, montgomery, montgomery_kernels
from fsdkr_tpu_torch.utils import lru

BITS = 144  # K = 9 limbs, odd
RNG_SEED = 9


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
    """A fresh precompute cache per test (the powers and contexts), and
    the JAX package's grouping rule (groups of 4 rows), so that these
    small columns take the comb."""
    monkeypatch.setattr(lru, "_GLOBAL", lru.BudgetLRU(1 << 24))
    monkeypatch.setattr(powm, "_SHARED_MIN_ROWS", jpowm._SHARED_MIN_ROWS)


def _modulus(rng):
    return rng.getrandbits(BITS) | 1 | (1 << (BITS - 1))


def _groups():
    """8 groups of 16, 5, 9, 1, 12, 3, 7 and 2 rows; group 1 is
    worst-case, group 2 holds a zero exponent."""
    rng = random.Random(RNG_SEED)
    sizes = (16, 5, 9, 1, 12, 3, 7, 2)
    moduli = [_modulus(rng) for _ in sizes]
    bases = [rng.randrange(2, m) for m in moduli]
    exps = [[rng.getrandbits(64) for _ in range(s)] for s in sizes]
    moduli[1] = (1 << BITS) - 1
    bases[1] = moduli[1] - 1
    exps[1] = [(1 << 64) - 1] * sizes[1]
    exps[2][3] = 0
    return bases, exps, moduli


def _want(bases, exps, moduli):
    return [[pow(b, e, m) for e in es] for b, es, m in zip(bases, exps, moduli)]


def test_shared_base_modexp_matches_reference():
    bases, exps, moduli = _groups()
    got = montgomery.shared_base_modexp(bases, exps, moduli, 9, device="cpu")
    assert got == _want(bases, exps, moduli)
    assert got == jmont.shared_base_modexp(bases, exps, moduli, 9, host_ladder=False)


def test_comb_ladder_matches_pow():
    """The ladder's wrapper on the CPU (its plain version): powers[w] = base^(16^w) * R mod n, R = 2^(16 K) with the engine's
    even K."""
    bases, _, moduli = _groups()
    ctx = montgomery.BatchModExp(moduli, 9, "cpu")
    k = ctx.ctx.num_limbs
    base = limbs.to_device(limbs.ints_to_limbs(bases, k), "cpu")
    powers = montgomery_kernels.comb_ladder(base, ctx._n, ctx._n_inv, ctx._r2, 16)
    got = [limbs.limbs_to_ints(powers[w].numpy()) for w in range(16)]
    r = 1 << (16 * k)
    assert got == [[pow(b, 16 ** w, m) * r % m for b, m in zip(bases, moduli)]
                   for w in range(16)]


def _column():
    """A flat column in shuffled order: five comb groups (12, 4, 7, 9 and
    5 rows) and loner groups of 3, 2 and 1 rows, 64-bit exponents."""
    rng = random.Random(RNG_SEED + 1)
    bases, exps, moduli = [], [], []
    for size in (12, 4, 7, 3, 9, 2, 5, 1):
        m = _modulus(rng)
        b = rng.randrange(2, m)
        for _ in range(size):
            bases.append(b)
            exps.append(rng.getrandbits(64))
            moduli.append(m)
    exps[0] = 0
    order = list(range(len(bases)))
    rng.shuffle(order)
    return [bases[i] for i in order], [exps[i] for i in order], [moduli[i] for i in order]


@pytest.fixture(scope="module")
def reference_column():
    bases, exps, moduli = _column()
    want = jpowm.tpu_powm_grouped(bases, exps, moduli)
    assert want == [pow(b, e, m) for b, e, m in zip(bases, exps, moduli)]
    return bases, exps, moduli, want


def _comb_groups(bases, exps, moduli):
    groups: dict = {}
    for b, e, m in zip(bases, exps, moduli):
        groups.setdefault((b, m), []).append(e)
    keys = [key for key, es in groups.items() if len(es) >= powm._SHARED_MIN_ROWS]
    return [b for b, _ in keys], [groups[key] for key in keys], [m for _, m in keys]


def test_device_powm_shared_matches_reference(reference_column):
    bases, exps, moduli, _ = reference_column
    gb, ge, gm = _comb_groups(bases, exps, moduli)
    assert sorted(len(e) for e in ge) == [4, 5, 7, 9, 12]
    got = powm.device_powm_shared(gb, ge, gm, "cpu")
    assert got == jpowm.tpu_powm_shared(gb, ge, gm)
    assert got == _want(gb, ge, gm)


@pytest.mark.parametrize(
    "max_rows, launches",
    [
        (16384, [(8, 16)]),  # one launch: 5 groups padded to 8, 12 rows to 16
        # g_cap = 4: the group axis tiles, the 4-row group last
        (64, [(4, 16), (2, 8)]),
        # row_chunk = 8 < 16 rows: the row axis tiles; then g_cap = 1
        (8, [(2, 8)] * 10),
    ],
    ids=["one-launch", "group-tiles", "row-and-group-tiles"],
)
def test_device_powm_grouped_matches_reference(reference_column, monkeypatch, max_rows,
                                               launches):
    bases, exps, moduli, want = reference_column
    monkeypatch.setattr(powm, "_MAX_ROWS", max_rows)
    seen = []
    raw = montgomery.shared_base_modexp

    def spy(bases, exps_per_group, *args, **kwargs):
        seen.append((len(bases), len(exps_per_group[0])))
        return raw(bases, exps_per_group, *args, **kwargs)

    monkeypatch.setattr(montgomery, "shared_base_modexp", spy)
    assert powm.device_powm_grouped(bases, exps, moduli, "cpu") == want
    assert seen == launches


def test_comb_context_cache_isolation():
    """device_powm_shared's Montgomery contexts in the precompute cache:
    cold and warm calls agree, the warm ones hit, and each modulus vector
    has an entry of its own."""
    rng = random.Random(RNG_SEED + 2)
    moduli_a = [_modulus(rng) for _ in range(2)]
    moduli_b = [_modulus(rng) for _ in range(2)]
    bases_a = [rng.randrange(2, m) for m in moduli_a]
    bases_b = [rng.randrange(2, m) for m in moduli_b]
    exps = [[rng.getrandbits(64) for _ in range(4)] for _ in range(2)]

    def run(bases, moduli):
        return powm.device_powm_shared(bases, exps, moduli, "cpu")

    cold_a = run(bases_a, moduli_a)
    lru.clear_caches()
    cold_b = run(bases_b, moduli_b)
    lru.clear_caches()
    assert run(bases_a, moduli_a) == cold_a
    assert run(bases_b, moduli_b) == cold_b
    hits = lru.cache_stats()["hits"]
    assert run(bases_a, moduli_a) == cold_a
    assert run(bases_b, moduli_b) == cold_b
    assert lru.cache_stats()["hits"] == hits + 2
    assert cold_a == _want(bases_a, exps, moduli_a)
    assert cold_b == _want(bases_b, exps, moduli_b)
    ctxs = [ctx for key, ctx in lru._GLOBAL._d.items() if key[0] == "mont-ctx"]
    assert sorted(ctx.ctx.moduli for ctx in ctxs) == sorted([moduli_a, moduli_b])


@pytest.mark.parametrize("forced", [False, True], ids=["routed", "rns-forced"])
def test_forced_rns_route_launches_no_comb(monkeypatch, forced):
    """The comb's wrappers, replaced by stand-ins that count their calls
    (on the CPU a wrapper runs its plain version and counts nothing):
    a column of two 6-row groups and two loners takes the comb when
    routed, and never inside `forced_rns_route()`."""
    calls = {"comb": 0, "comb_ladder": 0}
    for name in calls:
        raw = getattr(montgomery_kernels, name)

        def counted(*args, _raw=raw, _name=name, **kwargs):
            calls[_name] += 1
            return _raw(*args, **kwargs)

        monkeypatch.setattr(montgomery_kernels, name, counted)
    rng = random.Random(RNG_SEED + 3)
    m1, m2 = (rng.getrandbits(256) | 1 | (1 << 255) for _ in range(2))
    bases = [3] * 6 + [5] * 6 + [7, 11]
    moduli = [m1] * 6 + [m2] * 6 + [m1, m2]
    exps = [rng.getrandbits(128) for _ in bases]
    with powm.forced_rns_route() if forced else contextlib.nullcontext():
        got = powm.device_powm_grouped(bases, exps, moduli, "cpu")
    assert got == [pow(b, e, m) for b, e, m in zip(bases, exps, moduli)]
    assert calls == ({"comb": 0, "comb_ladder": 0} if forced else
                     {"comb": 1, "comb_ladder": 1})


@pytest.mark.parametrize("per_group, comb_launches", [(2, 0), (3, 1)])
def test_comb_takes_a_launch_from_its_group_count_up(monkeypatch, per_group, comb_launches):
    """A launch's one group takes the comb from _SHARED_MIN_ROWS rows up
    (there is no floor on the group count); a row short of it, every row
    takes the generic engine."""
    monkeypatch.setattr(powm, "_SHARED_MIN_ROWS", 3)
    calls = []
    raw = montgomery_kernels.comb
    monkeypatch.setattr(montgomery_kernels, "comb",
                        lambda *a, **kw: calls.append(1) or raw(*a, **kw))
    rng = random.Random(RNG_SEED + 4)
    bases, exps, moduli = [], [], []
    m = _modulus(rng)
    b = rng.randrange(2, m)
    for _ in range(per_group):
        bases.append(b)
        exps.append(rng.getrandbits(64))
        moduli.append(m)
    bases.append(7)  # a loner
    exps.append(rng.getrandbits(64))
    moduli.append(moduli[0])
    got = powm.device_powm_grouped(bases, exps, moduli, "cpu")
    assert got == [pow(b, e, m) for b, e, m in zip(bases, exps, moduli)]
    assert len(calls) == comb_launches


def test_get_batch_powm_routes_through_the_comb():
    from fsdkr_tpu_torch import TEST_CONFIG

    fn = powm.get_batch_powm(TEST_CONFIG)
    assert fn.func is powm.device_powm_grouped and fn.keywords == {"device": torch.device("cpu")}


def test_comb_wrappers_check_their_inputs():
    bases, exps, moduli = _groups()
    ctx = montgomery.BatchModExp(moduli[:2], 10, "cpu")
    n, ni, r2, one = ctx._n, ctx._n_inv, ctx._r2, ctx._one_mont
    base = torch.tensor([[1] + [0] * 9] * 2, dtype=torch.int32)
    before = montgomery_kernels.launch_counts()
    powers = montgomery_kernels.comb_ladder(base, n, ni, r2, 16)
    assert powers.shape == (16, 2, 10) and powers.dtype == torch.int32
    table = montgomery._comb_table(powers, n, ni, one, montgomery_kernels.mont_mul)
    exp = torch.zeros((2, 3, 4), dtype=torch.int32)
    out = montgomery_kernels.comb(table, exp, n, ni, one, 64)
    assert out.shape == (2, 3, 10) and bool((out[:, :, 0] == 1).all())
    assert montgomery_kernels.launch_counts() == before  # the plain versions ran
    with pytest.raises(ValueError):
        montgomery_kernels.comb(table[:, :15].contiguous(), exp, n, ni, one, 64)
    with pytest.raises(ValueError):
        montgomery_kernels.comb(table, exp, n, ni, one, 68)  # past the exponent limbs
    with pytest.raises(TypeError):
        montgomery_kernels.comb(table.long(), exp, n, ni, one, 64)
    with pytest.raises(ValueError):
        montgomery_kernels.comb(table.transpose(0, 1), exp, n, ni, one, 64)
    with pytest.raises(ValueError):
        montgomery_kernels.comb_ladder(base, n, ni, r2, 0)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            montgomery.shared_base_modexp([2], [[3]], [5], 2)  # the card by default
