"""The segmented `cios_modexp` launch (ops.montgomery_kernels
.modexp_segments), the engine's batches over it (ops.montgomery
.modexp_batches) and the column route that sends every width batch of a
`powm_columns` call into one launch (backend.powm.device_powm_batches).

- `powm_columns` over the port's `device_powm_grouped` (device="cpu")
  against the JAX package's `powm_columns` over `tpu_powm_grouped`
  (XLA:CPU) and CPython pow, on columns of mixed widths (K=16 and 32),
  exponent buckets (64 to 512 bits), a duplicate column, a comb group,
  a modulus-3 row and row counts that pad with modulus-3 rows: the
  generic rows of all width batches go to one `modexp_segments` call.
- The launch packing of `device_powm_batches`: rows past `_MAX_ROWS`
  and segments past `MAX_SEGMENTS` take further launches, with the same
  results.
- `modexp_batches` over contexts of different K against pow.
- The segmented wrapper's input checks.

On the CPU the wrapper runs the plain `_modexp_kernel` per segment; the
kernel itself is held against that on the card by chip_smoke.py. Inputs
come from seeded generators and go to both packages; every comparison is
exact.
"""

import random
from functools import partial

import pytest
import torch

from fsdkr_tpu.backend import powm as jpowm
from fsdkr_tpu_torch.backend import powm
from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels
from fsdkr_tpu_torch.utils import lru

RNG_SEED = 10


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
    rule (groups of 4 rows), so that a small group takes the comb as it
    does in the reference."""
    monkeypatch.setattr(lru, "_GLOBAL", lru.BudgetLRU(1 << 24))
    monkeypatch.setattr(powm, "_SHARED_MIN_ROWS", jpowm._SHARED_MIN_ROWS)


def _modulus(rng, bits):
    return rng.getrandbits(bits) | 1 | (1 << (bits - 1))


def _column(rng, rows, mod_bits, exp_bits):
    moduli = [_modulus(rng, mod_bits) for _ in range(rows)]
    bases = [rng.randrange(m) for m in moduli]
    exps = [rng.getrandbits(exp_bits) for _ in range(rows)]
    return bases, exps, moduli


def _columns():
    """(bases, exps, moduli) columns: 256-bit moduli (K=16) with 64-, 256-
    and 512-bit exponents, 512-bit moduli (K=32) with 64- and 512-bit
    exponents; row counts off a power of two (padded with modulus-3
    rows); a modulus-3 row, a zero exponent and an all-ones exponent; a
    duplicate column; a comb group of 6 rows sharing (base, modulus) at
    K=16 beside loners in its batch."""
    rng = random.Random(RNG_SEED)
    cols = [
        _column(rng, 5, 256, 64),
        _column(rng, 3, 256, 256),
        _column(rng, 7, 256, 512),
        _column(rng, 6, 512, 64),
        _column(rng, 9, 512, 512),
    ]
    b, e, m = cols[0]
    m[2], b[2] = 3, 2
    e[0] = 0
    cols[2][1][4] = (1 << 512) - 1
    n = _modulus(rng, 256)
    g = rng.randrange(n)
    comb = ([g] * 6 + [rng.randrange(n)], [rng.getrandbits(200) for _ in range(7)], [n] * 7)
    return cols + [cols[1], comb]


@pytest.fixture(scope="module")
def reference():
    cols = _columns()
    want = jpowm.powm_columns(jpowm.tpu_powm_grouped, *cols)
    assert want == [[pow(b, e, m) for b, e, m in zip(*col)] for col in cols]
    return cols, want


def _spy(monkeypatch, name):
    """Record the calls of a kernel wrapper (on the CPU it runs its plain
    version): for `modexp_segments` each call's segments as (K, rows,
    exp_bits)."""
    calls = []
    raw = getattr(montgomery_kernels, name)

    def spy(*args, **kwargs):
        if name == "modexp_segments":
            calls.append([(s[0].shape[1], s[0].shape[0], s[6]) for s in args[0]])
        else:
            calls.append(1)
        return raw(*args, **kwargs)

    monkeypatch.setattr(montgomery_kernels, name, spy)
    return calls


def test_powm_columns_launches_once_and_matches_reference(reference, monkeypatch):
    cols, want = reference
    launches = _spy(monkeypatch, "modexp_segments")
    combs = _spy(monkeypatch, "comb")
    fn = partial(powm.device_powm_grouped, device=torch.device("cpu"))
    got = powm.powm_columns(fn, *cols)
    assert got == want
    assert got[5] == got[1] and got[5] is not got[1]  # the duplicate, copied
    # one segment per width batch, padded to a power of two (at least 8
    # rows): (K=16, 64-bit exponents), (16, 256), (16, 512), (32, 64),
    # (32, 512); the comb column's 200-bit exponents bucket to 256 bits, so
    # its loner joins the 3 rows of (16, 256) and its 6-row group the comb
    assert launches == [[(16, 8, 64), (16, 8, 256), (16, 8, 512), (32, 8, 64),
                         (32, 16, 512)]]
    assert len(combs) == 1


def test_powm_columns_per_batch_callable_matches(reference, monkeypatch):
    """A callable that is not the device route gets one call per batch."""
    cols, want = reference
    launches = _spy(monkeypatch, "modexp_segments")
    got = powm.powm_columns(lambda b, e, m: powm.device_powm_grouped(b, e, m, "cpu"), *cols)
    assert got == want
    assert [len(call) for call in launches] == [1] * 5


@pytest.mark.parametrize(
    "max_rows, max_segments, sizes",
    [
        (16384, 32, [5]),  # batches of 8, 8, 8, 8 and 16 rows
        (16, 32, [2, 2, 1]),  # 8 + 8 rows a launch, then 16 alone
        (16384, 2, [2, 2, 1]),
        (8, 32, [1] * 6),  # the 9-row batch tiles into 8 + 1 (padded to 8)
    ],
    ids=["one-launch", "row-budget", "segment-budget", "tiled-batch"],
)
def test_device_powm_batches_packs_launches(reference, monkeypatch, max_rows,
                                            max_segments, sizes):
    cols, want = reference
    monkeypatch.setattr(powm, "_MAX_ROWS", max_rows)
    monkeypatch.setattr(montgomery_kernels, "MAX_SEGMENTS", max_segments)
    launches = _spy(monkeypatch, "modexp_segments")
    got = powm.device_powm_batches(cols[:5], "cpu")
    assert got == want[:5]
    assert [len(call) for call in launches] == sizes
    assert all(sum(rows for _, rows, _ in call) <= max_rows for call in launches)


def test_modexp_batches_over_contexts_of_different_k():
    rng = random.Random(RNG_SEED + 1)
    jobs, want = [], []
    for bits, rows, exp_bits in ((144, 3, 64), (512, 5, 512), (256, 2, 256)):
        bases, exps, moduli = _column(rng, rows, bits, exp_bits)
        ctx = montgomery.BatchModExp(moduli, -(-bits // 16), "cpu")
        jobs.append((ctx, bases, exps))
        want.append([pow(b, e, m) for b, e, m in zip(bases, exps, moduli)])
    assert [job[0].ctx.num_limbs for job in jobs] == [10, 32, 16]  # K=9 rounds up
    assert montgomery.modexp_batches(jobs) == want


def _segment(rows, k, exp_bits):
    ctx = montgomery.BatchModExp([_modulus(random.Random(k), 16 * k)] * rows, k, "cpu")
    return ctx.submit_modexp(list(range(2, rows + 2)), [5] * rows)[:6] + (exp_bits,)


def test_modexp_segments_checks_its_inputs():
    good = _segment(3, 16, 4)
    other = _segment(2, 32, 4)
    before = montgomery_kernels.launch_counts()
    out = montgomery_kernels.modexp_segments([good, other])
    assert [tuple(o.shape) for o in out] == [(3, 16), (2, 32)]
    assert montgomery_kernels.launch_counts() == before  # the plain versions ran
    base, exp, n, ni, r2, one, _ = good
    with pytest.raises(ValueError):  # no segment
        montgomery_kernels.modexp_segments([])
    with pytest.raises(ValueError):  # more than a launch takes
        montgomery_kernels.modexp_segments([good] * (montgomery_kernels.MAX_SEGMENTS + 1))
    with pytest.raises(ValueError):  # a bad segment shape: exponent rows
        montgomery_kernels.modexp_segments([good, (base, exp[:2], n, ni, r2, one, 4)])
    with pytest.raises(ValueError):  # a bad segment shape: base not (rows, K)
        montgomery_kernels.modexp_segments([(base[0], exp, n, ni, r2, one, 4)])
    with pytest.raises(ValueError):  # a bad segment: a field missing
        montgomery_kernels.modexp_segments([(base, exp, n, ni, r2, one)])
    for bad_bits in (0, 6, 68):  # not positive, not a window multiple, past the limbs
        with pytest.raises(ValueError):
            montgomery_kernels.modexp_segments([other, (base, exp, n, ni, r2, one, bad_bits)])
    # a K that differs from the segment's other tensors
    with pytest.raises(ValueError):
        montgomery_kernels.modexp_segments([(base, exp, n[:, :14].contiguous(), ni, r2, one, 4)])
    with pytest.raises(ValueError):
        montgomery_kernels.modexp_segments([good, (other[0], exp[:2], other[2], ni[:2], other[4],
                                                   other[5], 4)])
    with pytest.raises(TypeError):
        montgomery_kernels.modexp_segments([(base.long(), exp, n, ni, r2, one, 4)])
