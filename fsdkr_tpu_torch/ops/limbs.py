"""Limb-tensor representation of big integers.

Base 2^16 digits: a b-bit integer is ceil(b/16) limbs, little-endian along
the last axis. A digit product fits 32 bits exactly ((2^16-1)^2 < 2^32).
The host side builds numpy uint32 arrays; the device side holds them as
int32 tensors (every value < 2^16, so the signed type is exact).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

__all__ = [
    "LIMB_BITS",
    "LIMB_MASK",
    "WINDOW_BITS",
    "limbs_for_bits",
    "bucket_exp_bits",
    "ints_to_limbs",
    "limbs_to_ints",
    "wipe_array",
    "to_device",
    "MontgomeryContext",
]

WINDOW_BITS = 4  # fixed-window width of the modexp kernel

# Exponent-width ladder: modexp time is proportional to the bucketed
# width (sequential window loop), so the ladder is finer than powers of two
# where the protocol's exponent sizes actually fall (q*Ntilde ~ 2304 bits,
# q^3*Ntilde ~ 2816 bits for 2048-bit moduli). All entries are multiples of
# the window width.
_EXP_BUCKETS = (
    64, 128, 256, 512, 768, 1024, 1536, 2048, 2560, 3072, 4096,
    5120, 6144, 8192, 12288, 16384,
)


def bucket_exp_bits(exps) -> int:
    """Exponent width for a batch: the max bit length rounded up the
    bucket ladder. The window loop runs this many bits for EVERY row, so
    no row's own length shows in the launch (secret exponents)."""
    bits = max((e.bit_length() for e in exps), default=1) or 1
    for b in _EXP_BUCKETS:
        if bits <= b:
            return b
    return -(-bits // WINDOW_BITS) * WINDOW_BITS


def limbs_for_bits(bits: int) -> int:
    return -(-bits // LIMB_BITS)


def ints_to_limbs(xs: Sequence[int], num_limbs: int) -> np.ndarray:
    """(B,) Python ints -> (B, num_limbs) uint32 little-endian base-2^16.

    Via to_bytes + frombuffer: CPython serializes in C, so the host-side
    conversion cost is O(bytes). The staging bytearray is wiped in place
    before returning (astype copies out of it), so the returned array is
    the ONLY host copy — call wipe_array on it after the device upload
    when the values are secret (exponents, shares, nonces).
    """
    nbytes = num_limbs * (LIMB_BITS // 8)
    buf = bytearray(len(xs) * nbytes)
    for row, x in enumerate(xs):
        if x < 0:
            raise ValueError("limb encoding takes non-negative integers")
        try:
            buf[row * nbytes : (row + 1) * nbytes] = x.to_bytes(nbytes, "little")
        except OverflowError:
            raise ValueError(
                f"integer of {x.bit_length()} bits exceeds {num_limbs} limbs"
            ) from None
    arr16 = np.frombuffer(buf, dtype="<u2").reshape(len(xs), num_limbs)
    out = arr16.astype(np.uint32)
    buf[:] = bytes(len(buf))  # wipe staging bytes (out never aliases buf)
    return out


def wipe_array(*arrays) -> None:
    """Zero numpy staging arrays or torch tensors that held secret limb
    material, once the computation consuming them has materialized its
    results. No-op for None entries."""
    for a in arrays:
        if a is None:
            continue
        if isinstance(a, np.ndarray):
            if a.flags.writeable:
                a.fill(0)
        else:
            a.zero_()


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A limb array as an int32 tensor on `device`; the int32 host staging
    copy is zeroed once uploaded (it may hold secret limbs)."""
    host = torch.from_numpy(arr.astype(np.int32))
    out = host.to(device)
    if out.data_ptr() != host.data_ptr():
        host.zero_()
    return out


def limbs_to_ints(arr) -> List[int]:
    """(B, K) canonical limb array -> list of Python ints."""
    a = np.asarray(arr)
    if a.ndim != 2:
        raise ValueError("expected a (B, K) limb array")
    if (a >> LIMB_BITS).any() or (a < 0).any():
        raise ValueError("limb array not canonical (pending carries)")
    raw = a.astype("<u2").tobytes()
    nbytes = a.shape[1] * (LIMB_BITS // 8)
    return [
        int.from_bytes(raw[i * nbytes : (i + 1) * nbytes], "little")
        for i in range(a.shape[0])
    ]


class MontgomeryContext:
    """Per-batch-row Montgomery constants for a multi-modulus batch.

    For each (odd) modulus N_i with R = 2^(16*K):
      n_prime_i = -N_i^{-1} mod 2^16   (digit-level CIOS constant)
      r2_i      = R^2 mod N_i          (to-Montgomery conversion factor)
      one_i     = R mod N_i            (Montgomery representation of 1)
    and, for the port's CIOS engine (`ops.montgomery`):
      n_inv_i   = -N_i^{-1} mod R      (K limbs; its low two limbs are
                                        the 32-bit n' of the kernels,
                                        which work in 32-bit words)

    The constants are computed once per distinct modulus and gathered
    per row: a refresh's columns repeat each party's modulus on many
    rows (the ring-Pedersen column: 16 moduli on 4096 rows), and the two
    inversions cost about 0.5 ms a 2048-bit modulus on the host.
    """

    def __init__(self, moduli: Sequence[int], num_limbs: int):
        distinct = list(dict.fromkeys(moduli))
        for n in distinct:
            if n % 2 == 0 or n <= 1:
                raise ValueError("Montgomery arithmetic requires odd moduli > 1")
            if n.bit_length() > num_limbs * LIMB_BITS:
                raise ValueError("modulus wider than limb layout")
        self.num_limbs = num_limbs
        self.moduli = list(moduli)
        r = 1 << (LIMB_BITS * num_limbs)
        where = {n: i for i, n in enumerate(distinct)}
        row = np.array([where[n] for n in moduli], dtype=np.int64)
        self.n = ints_to_limbs(distinct, num_limbs)[row]
        self.n_prime = np.array(
            [(-pow(n, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS) for n in distinct],
            dtype=np.uint32,
        )[row]
        self.r2 = ints_to_limbs([r * r % n for n in distinct], num_limbs)[row]
        self.one_mont = ints_to_limbs([r % n for n in distinct], num_limbs)[row]
        self.n_inv = ints_to_limbs([(-pow(n, -1, r)) % r for n in distinct], num_limbs)[row]

    @property
    def n_prime32(self) -> np.ndarray:
        """-N^{-1} mod 2^32 per row (uint32)."""
        return self.n_inv[:, 0] | (self.n_inv[:, 1] << LIMB_BITS)
