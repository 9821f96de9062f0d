"""ctypes bridge to the native host bignum core (csrc/fsdkr_native.cpp).

The host ladders GMP has no amortized entry for: the single-candidate
Miller-Rabin (core/primes.py), the fixed-base comb of the secret-CRT
engine (backend/crt.py), and the CRT leg and Miller-Rabin batches. A
trimmed copy of the JAX package's fsdkr_tpu/native/ bridge; the library
is built with g++ at first use (native/_loader.py), and a failed build
raises instead of falling back to CPython, as does an input outside the
core's range (an even modulus, a negative exponent, a width over
`_MAX_LIMBS`): no call here takes a CPython path. Batches split their
rows over every core of the host (`set_threads` changes that, for tests,
and so the threads of the GMP bridge, native/gmp.py).

The Montgomery product runs on libgmp's mpn functions, resolved when the
library loads; a libgmp without them raises NativeBuildError.
`set_mpn(0)` puts the portable u128 loop back, a test hook with the same
results.

Limb staging follows the JAX package's wipe discipline: every buffer
that held a secret operand (a prime candidate, a leg modulus, an
exponent) is zeroed once the native call returns.
"""

from __future__ import annotations

import ctypes
import secrets
import threading
from typing import Dict, List, Sequence

from ..telemetry.spans import get_tracer
from ..utils.roofline import stamp_generic_host, stamp_shared_host
from ._loader import NativeBuildError, NativeLib, _PKG

__all__ = [
    "NativeBuildError",
    "available",
    "set_threads",
    "thread_count",
    "set_mpn",
    "engine_kind",
    "stats",
    "stats_reset",
    "crt_modexp_batch",
    "modexp_shared",
    "is_probable_prime",
    "is_probable_prime_batch",
]

_LIMB_BYTES = 8
_MAX_LIMBS = 130  # 8320 bits, keep in sync with MAXL in csrc

_U64P = ctypes.POINTER(ctypes.c_uint64)
_INT = ctypes.c_int


def _configure(lib: ctypes.CDLL) -> None:
    """Every core, and the mpn engine, which must resolve."""
    lib.fsdkr_set_threads(0)
    if lib.fsdkr_set_mpn(1) != 1:
        raise NativeBuildError(
            "libgmp.so.10's mpn functions did not resolve: the native core needs them")


LIB = NativeLib(
    _PKG / "csrc" / "fsdkr_native.cpp",
    {
        "fsdkr_set_threads": (_INT,),
        "fsdkr_get_threads": (),
        "fsdkr_set_mpn": (_INT,),
        "fsdkr_engine_kind": (),
        "fsdkr_miller_rabin": (_U64P, _INT, _U64P, _INT),
        "fsdkr_miller_rabin_batch": (_U64P, _U64P, ctypes.POINTER(_INT), _INT, _INT, _INT),
        "fsdkr_crt_modexp_batch": (_U64P, _U64P, _U64P, _U64P, _INT, _INT, _INT, _INT),
        "fsdkr_modexp_shared_w": (_U64P, _U64P, _U64P, _U64P, _INT, _INT, _INT, _INT),
    },
    on_load=_configure,
)

# calls that ran in the native core, by kind (chip_smoke gates on them)
_STATS: Dict[str, int] = {}
_STAT_KEYS = ("mr_batches", "mr_rows", "crt_batches", "crt_rows", "comb_calls", "comb_rows")
# the serving layer's workers and producer call the core side by side
_STATS_LOCK = threading.Lock()


def _count(**kw) -> None:
    with _STATS_LOCK:
        for k, v in kw.items():
            _STATS[k] = _STATS.get(k, 0) + v


def stats() -> Dict[str, int]:
    with _STATS_LOCK:
        return {k: _STATS.get(k, 0) for k in _STAT_KEYS}


def stats_reset() -> None:
    with _STATS_LOCK:
        _STATS.clear()


def _get() -> ctypes.CDLL:
    return LIB.get()


def available() -> bool:
    """Builds and loads the core if it is not yet loaded; True, or
    NativeBuildError."""
    _get()
    return True


def set_threads(n: int) -> int:
    """Row-parallel threads of the batch calls, here and in the GMP
    bridge (0: every core, 1: serial); results are the same at any
    count. Returns the count."""
    return int(_get().fsdkr_set_threads(int(n)))


def thread_count() -> int:
    return int(_get().fsdkr_get_threads())


def set_mpn(on: int) -> str:
    """The Montgomery product's engine: libgmp's mpn functions (on, the
    default) or the portable u128 loop (0), a test hook; results are
    bit-identical. Returns `engine_kind()`."""
    lib = _get()
    if lib.fsdkr_set_mpn(int(on)) != (1 if on else 0):
        raise NativeBuildError("libgmp.so.10's mpn functions did not resolve")
    return engine_kind()


def engine_kind() -> str:
    """The active engine: "mpn" (libgmp's asm basecase and REDC) or
    "portable" (the u128 CIOS/SOS loop, after `set_mpn(0)`)."""
    return "mpn" if _get().fsdkr_engine_kind() else "portable"


def _limbs_for(x: int) -> int:
    return max(1, -(-x.bit_length() // 64))


def _to_buf(xs: Sequence[int], limbs: int) -> ctypes.Array:
    """Limb staging for the C ABI. The bytearray is wiped in place before
    returning, so the only host copy of a secret operand left is the
    ctypes array, which callers wipe with _wipe_buf after the call."""
    step = limbs * _LIMB_BYTES
    buf = bytearray(len(xs) * step)
    for row, x in enumerate(xs):
        buf[row * step : (row + 1) * step] = x.to_bytes(step, "little")
    arr = (ctypes.c_uint64 * (len(xs) * limbs)).from_buffer_copy(buf)
    buf[:] = bytes(len(buf))
    return arr


def _wipe_buf(*arrays) -> None:
    for a in arrays:
        ctypes.memset(a, 0, ctypes.sizeof(a))


def _from_buf(buf, rows: int, limbs: int) -> List[int]:
    mv = memoryview(buf).cast("B")
    step = limbs * _LIMB_BYTES
    return [
        int.from_bytes(mv[i * step : (i + 1) * step], "little")
        for i in range(rows)
    ]


def _check_range(L: int, mods: Sequence[int], exps: Sequence[int], least: int = 3) -> None:
    """Raises ValueError unless every modulus is odd, at least `least`
    and at most `_MAX_LIMBS` limbs wide, and every exponent >= 0."""
    if L > _MAX_LIMBS:
        raise ValueError(f"modulus wider than the native core's {64 * _MAX_LIMBS} bits")
    if any(m % 2 == 0 or m < least for m in mods):
        raise ValueError(f"the native core takes odd moduli >= {least} only")
    if any(e < 0 for e in exps):
        raise ValueError("the native core takes exponents >= 0 only")


def _gen_window_bits(total_exp_bits: int) -> int:
    """Window width of the windowed ladder: lookups cost
    total_exp_bits/w, the table 2^w - 2 multiplies."""
    best, best_cost = 4, None
    for w in (4, 5, 6):
        cost = total_exp_bits / w + ((1 << w) - 2)
        if best_cost is None or cost < best_cost:
            best, best_cost = w, cost
    return best


def _comb_window_bits(ebits: int, m_rows: int) -> int:
    """Comb window width: lookups shrink as ebits/w while the table
    build (2^w - 2 per window, amortized over the rows) grows."""
    best, best_cost = 4, None
    for w in (4, 5, 6, 7, 8):
        cost = (ebits / w) * (1.0 + ((1 << w) - 2) / m_rows)
        if best_cost is None or cost < best_cost:
            best, best_cost = w, cost
    return best


def crt_modexp_batch(
    bases: Sequence[int], exps: Sequence[int], mods: Sequence[int]
) -> List[int]:
    """Row-wise bases^exps mod mods for the secret-CRT legs
    (backend/crt.py): every operand is secret-derived (a leg modulus
    holds a factor of the prover's key), so all four buffers are wiped.
    Montgomery constants are computed once per run of equal consecutive
    moduli. A leg outside the core's range (an even or wider than 8320-bit
    modulus, a negative exponent) raises ValueError: the JAX package's
    bridge takes CPython pow there, which would hide the cost."""
    if not bases:
        return []
    if not (len(bases) == len(exps) == len(mods)):
        raise ValueError("batch length mismatch")
    L = max(_limbs_for(m) for m in mods)
    _check_range(L, mods, exps)
    lib = _get()
    EL = max(1, max(_limbs_for(e) for e in exps))
    rows = len(bases)
    out = (ctypes.c_uint64 * (rows * L))()
    base_buf = _to_buf([b % m for b, m in zip(bases, mods)], L)
    exp_buf = _to_buf(list(exps), EL)
    mod_buf = _to_buf(list(mods), L)
    rc = lib.fsdkr_crt_modexp_batch(
        base_buf, exp_buf, mod_buf, out, rows, L, EL,
        _gen_window_bits(max(e.bit_length() for e in exps)),
    )
    if rc != 0:
        _wipe_buf(base_buf, exp_buf, mod_buf, out)
        raise ValueError(f"fsdkr_crt_modexp_batch rejected its input ({rc})")
    res = _from_buf(out, rows, L)
    _wipe_buf(base_buf, exp_buf, mod_buf, out)
    _count(crt_batches=1, crt_rows=rows)
    return res


def modexp_shared(base: int, exps: Sequence[int], mod: int) -> List[int]:
    """base^exps[i] mod mod through the fixed-base comb: one squaring
    ladder over the whole column, rows split over the cores. The table
    is built, used and wiped in one call, as a secret base needs (the
    CRT legs of ring-Pedersen's prover; the JAX package's
    `modexp_shared(..., cache=False)`). An input outside the core's
    range raises ValueError."""
    if not exps:
        return []
    # the comb's roofline stamp, its exponents priced at the (public)
    # modulus width: their own widths are secret-derived
    if get_tracer().enabled:
        stamp_shared_host(1, len(exps), mod.bit_length(), mod.bit_length())
    L = _limbs_for(mod)
    EL = max(1, max(_limbs_for(e) for e in exps))
    _check_range(L, [mod], exps)
    if EL > 2 * _MAX_LIMBS:
        raise ValueError(f"exponent wider than the native core's {128 * _MAX_LIMBS} bits")
    lib = _get()
    m_rows = len(exps)
    wbits = _comb_window_bits(EL * 64, m_rows)
    out = (ctypes.c_uint64 * (m_rows * L))()
    exp_buf = _to_buf(list(exps), EL)
    mod_buf = _to_buf([mod], L)
    base_buf = _to_buf([base % mod], L)
    rc = lib.fsdkr_modexp_shared_w(
        base_buf, exp_buf, mod_buf, out, m_rows, L, EL, wbits
    )
    if rc != 0:
        _wipe_buf(base_buf, exp_buf, mod_buf, out)
        raise ValueError(f"fsdkr_modexp_shared_w rejected its input ({rc})")
    res = _from_buf(out, m_rows, L)
    _wipe_buf(base_buf, exp_buf, mod_buf, out)
    _count(comb_calls=1, comb_rows=m_rows)
    return res


def is_probable_prime_batch(
    ns: Sequence[int], rounds: int = 30
) -> List[bool]:
    """Miller-Rabin over a batch of candidates with CSPRNG witnesses,
    candidates split over the cores: the prime pipeline's shape, one
    native call a sieve window. A candidate outside the core's range (even,
    below 5, wider than 8320 bits) raises ValueError."""
    if not ns:
        return []
    L = max(_limbs_for(n) for n in ns)
    _check_range(L, ns, (), least=5)
    # each round one modexp at the candidate width (the public bit size
    # the caller asked for)
    if get_tracer().enabled:
        bits = max(n.bit_length() for n in ns)
        stamp_generic_host(len(ns) * rounds, bits, bits)
    lib = _get()
    rows = len(ns)
    witnesses = [
        2 + secrets.randbelow(n - 3) for n in ns for _ in range(rounds)
    ]
    verdicts = (ctypes.c_int * rows)()
    n_buf = _to_buf(list(ns), L)  # prime candidates: secret key material
    wit_buf = _to_buf(witnesses, L)
    rc = lib.fsdkr_miller_rabin_batch(n_buf, wit_buf, verdicts, rows, L, rounds)
    _wipe_buf(n_buf, wit_buf)
    if rc != 0:
        raise ValueError(f"fsdkr_miller_rabin_batch rejected its input ({rc})")
    _count(mr_batches=1, mr_rows=rows)
    return [bool(v) for v in verdicts]


def is_probable_prime(n: int, rounds: int = 30) -> bool:
    """Miller-Rabin with CSPRNG witnesses, the rounds split over the
    cores. ValueError when n is outside the core's range."""
    L = _limbs_for(n)
    _check_range(L, [n], (), least=5)
    lib = _get()
    witnesses = [2 + secrets.randbelow(n - 3) for _ in range(rounds)]
    n_buf = _to_buf([n], L)  # prime candidate: secret key material
    wit_buf = _to_buf(witnesses, L)
    rc = lib.fsdkr_miller_rabin(n_buf, L, wit_buf, rounds)
    _wipe_buf(n_buf, wit_buf)
    if rc < 0:
        raise ValueError(f"fsdkr_miller_rabin rejected its input ({rc})")
    return bool(rc)
