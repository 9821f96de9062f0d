"""Batched modular exponentiation and multiplication columns.

`distribute`'s per-receiver fan-out and every verifier family are
expressed against a `batch_powm(bases, exps, moduli) -> list[int]`
callable:

- host_powm: CPython pow loop (oracle).
- device_powm: every row through the RNS route (ops.rns, kernel 2), one
  launch per width class and tile of at most _MAX_ROWS rows.
- device_modmul: a*b mod N per row through ops.rns (kernel 1, two
  launches).

Batches are padded to powers of two (>= 8 rows; padding rows use
modulus 3) so launch shapes repeat across calls.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Sequence

from ..config import ProtocolConfig
from ..ops.limbs import bucket_exp_bits, limbs_for_bits

BatchPowm = Callable[[Sequence[int], Sequence[int], Sequence[int]], List[int]]

# rows per launch: bounds the device staging of one launch
_MAX_ROWS = 16384

# modulus width classes with prepared RNS bases (caps distinct launch
# shapes; moduli bucket up to the nearest class). Wider moduli take a
# multiple of 1024 bits, up to the widest class the kernels are held at
# on the card (7168 bits: kernel 2 holds 4 rows per block there).
_RNS_WIDTH_CLASSES = (256, 512, 1024, 1536, 2048, 3072, 4096)
_MAX_CLASS_BITS = 7168


def _width_class(width: int) -> int:
    for cls in _RNS_WIDTH_CLASSES:
        if width <= cls:
            return cls
    cls = -(-width // 1024) * 1024
    if cls > _MAX_CLASS_BITS:
        raise ValueError(
            f"{width}-bit modulus exceeds the RNS kernels' {_MAX_CLASS_BITS} bits"
        )
    return cls


def _pad_pow2(rows: int) -> int:
    return max(8, 1 << (rows - 1).bit_length())


def host_powm(bases, exps, moduli) -> List[int]:
    """Host batched modexp: CPython pow per row."""
    return [pow(b, e, m) for b, e, m in zip(bases, exps, moduli)]


def device_powm(bases, exps, moduli, device="cuda") -> List[int]:
    """bases^exps mod moduli row-wise on `device` (counterpart of the JAX
    package's tpu_powm, every row through the RNS route)."""
    if not bases:
        return []
    if len(bases) > _MAX_ROWS:
        out: List[int] = []
        for lo in range(0, len(bases), _MAX_ROWS):
            hi = lo + _MAX_ROWS
            out += device_powm(bases[lo:hi], exps[lo:hi], moduli[lo:hi], device)
        return out
    from ..ops.rns import rns_modexp

    b = len(bases)
    pad = _pad_pow2(b) - b
    bases = list(bases) + [1] * pad
    exps = list(exps) + [0] * pad
    moduli = list(moduli) + [3] * pad
    cls = _width_class(max(m.bit_length() for m in moduli))
    return rns_modexp(bases, exps, moduli, cls, device)[:b]


def device_modmul(a, b, moduli, device="cuda") -> List[int]:
    """Row-wise a*b mod moduli on `device` (counterpart of the JAX
    package's tpu_modmul; the same integers, through kernel 1)."""
    if not a:
        return []
    if len(a) > _MAX_ROWS:
        out: List[int] = []
        for lo in range(0, len(a), _MAX_ROWS):
            hi = lo + _MAX_ROWS
            out += device_modmul(a[lo:hi], b[lo:hi], moduli[lo:hi], device)
        return out
    from ..ops.rns import rns_modmul

    rows = len(a)
    pad = _pad_pow2(rows) - rows
    a = list(a) + [1] * pad
    b = list(b) + [1] * pad
    moduli = list(moduli) + [3] * pad
    cls = _width_class(max(m.bit_length() for m in moduli))
    return rns_modmul(a, b, moduli, cls, device)[:rows]


def get_batch_powm(config: ProtocolConfig) -> BatchPowm:
    if config.backend == "host":
        return host_powm
    return partial(device_powm, device=config.torch_device())


def powm_columns(powm: BatchPowm, *columns):
    """Fuse several (bases, exps, moduli) columns into per-width batched
    launches and split the results back.

    Columns are fused ONLY within the same bucketed exponent width AND
    the same modulus limb width: a launch costs sequential depth
    proportional to its widest exponent and is sized by its widest
    modulus, so a narrow column riding a wide launch would pay for the
    width. Identical columns (the PDL and Alice provers both commit
    h1^x mod N~ over the same share column) share one computation.
    """
    by_prefix: dict = {}  # cheap prefix -> [column indices]
    alias: dict = {}  # later column index -> first column index
    flat: dict = {}  # width class -> (bases, exps, moduli, [(col, lo, hi)])
    for col, (bases, exps, moduli) in enumerate(columns):
        prefix = (
            len(bases),
            bases[0] if bases else 0,
            exps[0] if exps else 0,
            moduli[0] if moduli else 0,
        )
        dup = None
        for prev in by_prefix.get(prefix, ()):
            pb, pe, pm = columns[prev]
            if list(pb) == list(bases) and list(pe) == list(exps) and list(pm) == list(moduli):
                dup = prev
                break
        if dup is not None:
            alias[col] = dup
            continue
        by_prefix.setdefault(prefix, []).append(col)
        w = (
            bucket_exp_bits(exps),
            limbs_for_bits(max(m.bit_length() for m in moduli)) if moduli else 0,
        )
        b, e, m, spans = flat.setdefault(w, ([], [], [], []))
        spans.append((col, len(b), len(b) + len(bases)))
        b += list(bases)
        e += list(exps)
        m += list(moduli)

    out: list = [None] * len(columns)
    for b, e, m, spans in flat.values():
        res = powm(b, e, m)
        for col, lo, hi in spans:
            out[col] = res[lo:hi]
    for col, dup in alias.items():
        out[col] = list(out[dup])  # fresh list: no aliasing across columns
    return out
