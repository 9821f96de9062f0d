"""ctypes bridge to the native secp256k1 host core (csrc/fsdkr_ec.cpp).

The host's Feldman check (`backend.batch_verifier.HostBatchVerifier
.validate_feldman`: one Horner launch a commitment vector) and the PDL
u1 check the cuda backend falls back to when its combined u1 MSM fails
(`backend.cuda_verifier.CudaBatchVerifier._pdl_u1_host`: one linear
combination launch). The JAX package's fsdkr_tpu/native/ec.py as the
port's own copy, without `scalar_mul_batch` (no port caller); built with
g++ at first use into `build/` (native/_loader.py), raising
NativeBuildError where the build fails. Rows split over
`native.thread_count()` threads.

Inputs are public broadcast values (commitments, proof points, indices),
so no wipe discipline applies; the arithmetic is variable-time, as the
Python points it replaces.

Guards at the C boundary, where the core trusts its row counts: sequences
of mismatched lengths raise ValueError (a caller's bug; the core would
read past a short buffer), and so does a scalar outside [0, 2^256)
(refused before it is staged). An index outside [0, 2^32) is outside the
core's domain, not a bug: `horner_batch` returns None there, as the JAX
package's does, and the caller checks those rows with the Python points.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ._loader import NativeBuildError, NativeLib, _PKG

__all__ = [
    "NativeBuildError",
    "available",
    "horner_batch",
    "lincomb2_batch",
    "stats",
    "stats_reset",
]

Affine = Optional[Tuple[int, int]]  # None = point at infinity

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_INT = ctypes.c_int
LIB = NativeLib(
    _PKG / "csrc" / "fsdkr_ec.cpp",
    {
        "fsdkr_ec_set_threads": (_INT,),
        "fsdkr_ec_horner_batch": (_U64P, _INT, _U32P, _INT, _U64P),
        "fsdkr_ec_lincomb2_batch": (_U64P, _U64P, _U64P, _U64P, _INT, _U64P),
    },
)

# launches and rows, by entry point (tests and chip_smoke read them)
_STATS: Dict[str, int] = {}
_STAT_KEYS = ("horner_batches", "horner_rows", "lincomb2_batches", "lincomb2_rows")
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
    """The library, its row threads set to the bignum core's count."""
    from . import thread_count

    lib = LIB.get()
    lib.fsdkr_ec_set_threads(thread_count())
    return lib


def available() -> bool:
    """Builds and loads the core if it is not yet loaded; True, or
    NativeBuildError."""
    LIB.get()
    return True


def _points_buf(points: Sequence[Affine]) -> ctypes.Array:
    """(x, y) pairs as 8 LE u64 limbs each; None -> (0, 0) identity."""
    buf = bytearray(len(points) * 64)
    for i, pt in enumerate(points):
        if pt is not None:
            x, y = pt
            buf[i * 64 : i * 64 + 32] = x.to_bytes(32, "little")
            buf[i * 64 + 32 : i * 64 + 64] = y.to_bytes(32, "little")
    return (ctypes.c_uint64 * (len(points) * 8)).from_buffer_copy(buf)


def _scalars_buf(scalars: Sequence[int]) -> ctypes.Array:
    """32-byte LE scalar staging; ValueError for a scalar outside
    [0, 2^256), before any is staged."""
    if any(not (0 <= s < (1 << 256)) for s in scalars):
        raise ValueError("a scalar outside [0, 2^256): callers reduce mod the group order")
    buf = bytearray(len(scalars) * 32)
    for i, s in enumerate(scalars):
        buf[i * 32 : (i + 1) * 32] = s.to_bytes(32, "little")
    return (ctypes.c_uint64 * (len(scalars) * 4)).from_buffer_copy(buf)


def _read_points(out: ctypes.Array, n: int) -> List[Affine]:
    mv = memoryview(bytearray(out))
    res: List[Affine] = []
    for i in range(n):
        x = int.from_bytes(mv[i * 64 : i * 64 + 32], "little")
        y = int.from_bytes(mv[i * 64 + 32 : i * 64 + 64], "little")
        res.append(None if x == 0 and y == 0 else (x, y))
    return res


def horner_batch(
    commitments: Sequence[Affine], indices: Sequence[int]
) -> Optional[List[Affine]]:
    """[sum_k A_k * u^k for u in indices], Horner over the commitment
    vector (A_0 first): the Feldman evaluation, in the Python check's
    order. None where the core cannot take the input (no commitment, an
    index outside [0, 2^32)): the caller checks those rows with the
    Python points."""
    if not indices:
        return []
    if not commitments or any(not (0 <= u < (1 << 32)) for u in indices):
        return None
    lib = _get()
    commits = _points_buf(commitments)
    idx = (ctypes.c_uint32 * len(indices))(*indices)
    out = (ctypes.c_uint64 * (len(indices) * 8))()
    rc = lib.fsdkr_ec_horner_batch(commits, len(commitments), idx, len(indices), out)
    if rc != 0:
        raise ValueError(f"fsdkr_ec_horner_batch rejected its input ({rc})")
    _count(horner_batches=1, horner_rows=len(indices))
    return _read_points(out, len(indices))


def lincomb2_batch(
    P: Sequence[Affine],
    a: Sequence[int],
    Q: Sequence[Affine],
    b: Sequence[int],
) -> List[Affine]:
    """[a_i*P_i + b_i*Q_i]: the PDL u1 shape, s1*G + (q - e)*Q. The four
    sequences must have one length and the scalars lie in [0, 2^256)
    (ValueError otherwise)."""
    if not (len(a) == len(b) == len(Q) == len(P)):
        raise ValueError("lincomb2_batch: sequences of different lengths")
    if not P:
        return []
    a_buf = _scalars_buf(a)
    b_buf = _scalars_buf(b)
    lib = _get()
    out = (ctypes.c_uint64 * (len(P) * 8))()
    rc = lib.fsdkr_ec_lincomb2_batch(_points_buf(P), a_buf, _points_buf(Q), b_buf, len(P), out)
    if rc != 0:
        raise ValueError(f"fsdkr_ec_lincomb2_batch rejected its input ({rc})")
    _count(lincomb2_batches=1, lincomb2_rows=len(P))
    return _read_points(out, len(P))
