"""ctypes bridge to the system GMP (libgmp.so.10), the port's host bignum
engine.

The reference's host bignum layer is GMP (its curv/kzen-paillier
backend), so every host modexp of the original runs through `mpz_powm`.
This is the JAX package's fsdkr_tpu/native/gmp.py as the port's own
copy. Its callers: `core.intops.mod_pow` (odd moduli of 1024 bits and
up: Paillier encrypt, decrypt's unchecked legs, homomorphic `mul`, the
RLC host bisection's rows, correct-key, composite-dlog, keygen's h2),
`backend.powm.host_powm` (the provers' host columns), the secret-CRT
legs (`backend.crt`, `secret=True`), and the prime pipeline
(`core.primes`: the sieve's `gcd` and the Miller-Rabin rounds).

Departures from the JAX package: no FSDKR_GMP gate and no FSDKR_THREADS
read. A libgmp that does not load, or lacks a symbol, raises
NativeBuildError: no call takes a CPython path. Batches split their rows
over `native.thread_count()` threads (`native.set_threads` changes it).
A negative exponent keeps the JAX contract: CPython `pow`, whose
ValueError for a non-invertible base is what callers expect (`mpz_powm`
would divide by zero and kill the process).

`secret=True` takes `mpz_powm_sec`, GMP's constant-time ladder, for odd
moduli and exp > 0 (every CRT leg: its modulus is p*r or q*r); any
other row takes the plain `mpz_powm`.

Wipe discipline: every staging bytearray and every mpz limb buffer made
here is zeroed before it is freed (`_clear`). GMP's internal powm
scratch cannot be reached from outside. A PublicOperand's limbs are
public: never wiped, never freed.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, TypeVar

from ._loader import NativeBuildError

__all__ = [
    "NativeBuildError",
    "available",
    "library_path",
    "version",
    "powm",
    "powm_batch",
    "gcd",
    "PublicOperand",
    "map_rows",
    "stats",
    "stats_reset",
]


class _mpz_t(ctypes.Structure):
    # GMP's public __mpz_struct ABI (gmp.h): {int _mp_alloc; int _mp_size;
    # mp_limb_t *_mp_d} with 64-bit limbs on every LP64 target.
    _fields_ = [
        ("_mp_alloc", ctypes.c_int),
        ("_mp_size", ctypes.c_int),
        ("_mp_d", ctypes.POINTER(ctypes.c_uint64)),
    ]


_P = ctypes.POINTER(_mpz_t)
# the ladders release the GIL (CDLL), so rows run side by side; every
# other call is microseconds and holds it (PyDLL): with each of a row's
# dozen staging calls releasing and retaking it, threads queued on the
# GIL (1088-bit rows 0.415 ms each at 8 threads on an H100 machine's
# 8-core host, 0.229 ms with only the ladders releasing it)
_RELEASE_GIL = ("__gmpz_powm", "__gmpz_powm_sec")
_SYMBOLS = {
    "__gmpz_init": ([_P], None),
    "__gmpz_clear": ([_P], None),
    "__gmpz_import": ([_P, ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t,
                       ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p], None),
    "__gmpz_export": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
                       ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t, _P], ctypes.c_void_p),
    "__gmpz_powm": ([_P, _P, _P, _P], None),
    "__gmpz_powm_sec": ([_P, _P, _P, _P], None),
    "__gmpz_gcd": ([_P, _P, _P], None),
    "__gmpz_tdiv_r": ([_P, _P, _P], None),
}
_SONAMES = ("libgmp.so.10", "libgmp.so")


class _Lib:
    """The bound GMP entry points, each an attribute by its symbol name,
    and C's memset (holding the GIL, as ctypes.memset does not)."""


_LIB: Optional[_Lib] = None
_LOCK = threading.Lock()

# rows that ran in GMP, by kind (chip_smoke gates on them); the serving
# layer's workers, launcher and producer call the bridge side by side
_STATS: Dict[str, int] = {}
_STAT_KEYS = ("powm_batches", "powm_rows", "powm_sec_rows", "gcd_calls")
_STATS_LOCK = threading.Lock()


def _count(**kw) -> None:
    with _STATS_LOCK:
        for k, v in kw.items():
            _STATS[k] = _STATS.get(k, 0) + v


def stats() -> Dict[str, int]:
    """Rows that ran in GMP since the last `stats_reset()`: powm rows
    (all, and those on `mpz_powm_sec`), powm_batch calls, gcds."""
    with _STATS_LOCK:
        return {k: _STATS.get(k, 0) for k in _STAT_KEYS}


def stats_reset() -> None:
    with _STATS_LOCK:
        _STATS.clear()


def _load() -> _Lib:
    errors = []
    names = list(_SONAMES)
    found = ctypes.util.find_library("gmp")
    if found and found not in names:
        names.append(found)
    for name in names:
        try:
            released, held = ctypes.CDLL(name), ctypes.PyDLL(name)
        except OSError as e:
            errors.append(str(e))
            continue
        lib = _Lib()
        try:
            for sym, (argtypes, restype) in _SYMBOLS.items():
                fn = getattr(released if sym in _RELEASE_GIL else held, sym)
                fn.argtypes = argtypes
                fn.restype = restype
                setattr(lib, sym, fn)
            lib.version = ctypes.c_char_p.in_dll(held, "__gmp_version").value.decode()
        except (AttributeError, ValueError) as e:
            raise NativeBuildError(f"{name} lacks a GMP symbol: {e}") from e
        lib.memset = ctypes.PyDLL(None).memset  # the process's C library
        lib.memset.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t]
        lib.memset.restype = ctypes.c_void_p
        return lib
    raise NativeBuildError(f"libgmp did not load ({'; '.join(errors)}): the port's host "
                           f"bignum layer needs libgmp.so.10")


def _get() -> _Lib:
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _load()
    return _LIB


def available() -> bool:
    """Loads libgmp if it is not yet loaded; True, or NativeBuildError."""
    _get()
    return True


def version() -> str:
    """libgmp's `__gmp_version`."""
    return _get().version


def library_path() -> str:
    """The file libgmp was loaded from, as this process maps it."""
    _get()
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split(maxsplit=5)[-1].strip()
            if "/libgmp.so" in path:
                return path
    raise NativeBuildError("libgmp is loaded but not mapped from a file")


def _to_mpz(lib, x: int) -> _mpz_t:
    z = _mpz_t()
    lib.__gmpz_init(ctypes.byref(z))
    nb = (x.bit_length() + 7) // 8 or 1
    buf = bytearray(x.to_bytes(nb, "little"))
    lib.__gmpz_import(
        ctypes.byref(z), nb, -1, 1, 0, 0,
        (ctypes.c_char * nb).from_buffer(buf),
    )
    buf[:] = bytes(nb)  # wipe the staging copy in place
    return z


def _from_mpz(lib, z: _mpz_t) -> int:
    size = abs(z._mp_size)
    if size == 0:
        return 0
    buf = ctypes.create_string_buffer(size * 8)
    cnt = ctypes.c_size_t()
    lib.__gmpz_export(buf, ctypes.byref(cnt), -1, 1, 0, 0, ctypes.byref(z))
    out = int.from_bytes(buf.raw[: cnt.value], "little")
    lib.memset(buf, 0, len(buf))
    return out


def _clear(lib, *zs: _mpz_t) -> None:
    """Zero the mpz limb storage (the only heap copy GMP lets us reach),
    then free it."""
    for z in zs:
        if z._mp_d and z._mp_alloc > 0:
            lib.memset(z._mp_d, 0, z._mp_alloc * 8)
        lib.__gmpz_clear(ctypes.byref(z))


def _powm(lib, base: int, exp: int, mod: int, secret: bool) -> int:
    """One row in GMP (exp >= 0, mod > 0); `secret` takes mpz_powm_sec
    where its domain allows (odd modulus, exp > 0)."""
    zb = _to_mpz(lib, base % mod)
    ze = _to_mpz(lib, exp)
    zm = _to_mpz(lib, mod)
    zr = _to_mpz(lib, 0)
    fn = lib.__gmpz_powm_sec if secret else lib.__gmpz_powm
    fn(ctypes.byref(zr), ctypes.byref(zb), ctypes.byref(ze), ctypes.byref(zm))
    res = _from_mpz(lib, zr)
    _clear(lib, zb, ze, zm, zr)
    return res


def _sec(secret: bool, exp: int, mod: int) -> bool:
    return secret and exp > 0 and mod & 1 == 1


def powm(base: int, exp: int, mod: int, secret: bool = False) -> int:
    """base^exp mod mod through mpz_powm (secret=True: mpz_powm_sec where
    the row allows it, see the module docstring). A negative exponent or
    a modulus <= 0 takes CPython pow, the JAX package's contract."""
    if exp < 0 or mod <= 0:
        return pow(base, exp, mod)
    sec = _sec(secret, exp, mod)
    res = _powm(_get(), base, exp, mod, sec)
    _count(powm_rows=1, powm_sec_rows=int(sec))
    return res


_T = TypeVar("_T")


def map_rows(fn: Callable[[_T], object], items: Sequence[_T]) -> list:
    """[fn(x) for x in items], the items split into contiguous spans
    over `native.thread_count()` threads (one pool a call, none for one
    span). For row functions whose work is GMP calls: ctypes releases
    the GIL around each, so the spans run side by side."""
    from . import thread_count

    rows = len(items)
    nt = min(thread_count(), rows)
    if nt <= 1:
        return [fn(x) for x in items]
    spans = [(i * rows // nt, (i + 1) * rows // nt) for i in range(nt)]
    with ThreadPoolExecutor(max_workers=nt, thread_name_prefix="fsdkr-gmp") as ex:
        parts = list(ex.map(lambda s: [fn(items[i]) for i in range(*s)], spans))
    return [v for part in parts for v in part]


def powm_batch(
    bases: Sequence[int],
    exps: Sequence[int],
    mods: Sequence[int],
    secret: bool = False,
) -> List[int]:
    """Row-wise bases^exps mod mods through mpz_powm(_sec), rows split
    over `native.thread_count()` threads (`map_rows`); the results are the
    same at any count. Rows outside GMP's domain as in `powm`."""
    if not (len(bases) == len(exps) == len(mods)):
        raise ValueError("batch length mismatch")
    if not bases:
        return []
    lib = _get()

    def row(i: int):
        b, e, m = bases[i], exps[i], mods[i]
        if e < 0 or m <= 0:
            return pow(b, e, m), 0, 0
        sec = _sec(secret, e, m)
        return _powm(lib, b, e, m, sec), 1, int(sec)

    out = map_rows(row, range(len(bases)))
    _count(powm_batches=1, powm_rows=sum(r[1] for r in out),
           powm_sec_rows=sum(r[2] for r in out))
    return [r[0] for r in out]


class PublicOperand:
    """A PUBLIC integer imported into mpz form once and reused across
    calls (the prime sieve's primorial of ~23 kbit would otherwise pay
    its import on every gcd). Only for public values: the held limbs are
    never wiped and never freed."""

    def __init__(self, x: int):
        self.value = abs(x)
        self._z = _to_mpz(_get(), self.value)


def gcd(a: int, b) -> int:
    """gcd(a, b) through mpz_gcd; `b` may be a PublicOperand, which is
    first folded down to |a| with one mpz_tdiv_r (the sieve's shape,
    ~3x the straight mpz_gcd against a wide cached operand). The
    operand limbs of `a` (a prime candidate: secret) are wiped."""
    lib = _get()
    a = abs(a)
    public = isinstance(b, PublicOperand)
    if a == 0:  # tdiv_r by zero would divide by zero
        _count(gcd_calls=1)
        return b.value if public else abs(b)
    za = _to_mpz(lib, a)
    zr = _to_mpz(lib, 0)
    if public:
        lib.__gmpz_tdiv_r(ctypes.byref(zr), ctypes.byref(b._z), ctypes.byref(za))
        lib.__gmpz_gcd(ctypes.byref(zr), ctypes.byref(za), ctypes.byref(zr))
        res = _from_mpz(lib, zr)
        _clear(lib, za, zr)  # b's limbs are cached and public
    else:
        zb = _to_mpz(lib, abs(b))
        lib.__gmpz_gcd(ctypes.byref(zr), ctypes.byref(za), ctypes.byref(zb))
        res = _from_mpz(lib, zr)
        _clear(lib, za, zb, zr)
    _count(gcd_calls=1)
    return res
