"""Batched secp256k1 point arithmetic on the device (the port of the JAX
package's `ops/ec_batch.py`).

The O(n^2) EC checks of collect() (PDL u1, Feldman share validation, the
pk_vec rebuild) and the prover's generator fan-out become a handful of
batched scalar multiplications and multi-scalar multiplications.

- Field: F_p for p = 2^256 - 2^32 - 977, as 16 x 16-bit limbs, every
  element in the Montgomery domain (x*R mod p, R = 2^256) and canonical
  (< p) after every operation. The plain products reuse the CIOS
  engine's plain Montgomery product (`ops.montgomery._Reducer`) with the
  modulus row p, and its carry helpers.
- Points: homogeneous projective (X : Y : Z), identity (0 : 1 : 0), with
  the complete addition law of Renes-Costello-Batina 2016 (Alg. 7,
  a = 0, b3 = 21): one formula for add, double, identity and inverses,
  with no data-dependent control flow.
- Scalar mul: MSB-first 4-bit fixed windows over a fixed width (256 for
  group-order scalars, 128 for random-linear-combination weights): a
  16-entry table per row, then per window 4 doublings and one masked
  table add.
- MSM: one scalar-mul launch over all rows, then a log-depth tree of
  complete adds within each group (groups padded to a power of two with
  identity points).

The two kernels, `_scalar_mul_kernel` and `_tree_sum_kernel`, are the
hand-written Hopper kernels of `ops.ec_kernels` on a CUDA device; the
functions of the same names here are their plain versions, which the
wrappers run for a CPU tensor. Every field operation leaves the unique
canonical value, so the plain versions and the kernels give the JAX
package's projective tensors bit for bit. Plain limbs are int64 (the
CPU kernels of torch have no uint32 add); int32 tensors of canonical
16-bit limbs cross the kernel boundary.

The host oracle for all of this is `core.secp256k1`.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Sequence

import numpy as np
import torch

from ..core.secp256k1 import N as CURVE_ORDER
from ..core.secp256k1 import P as FIELD_P
from ..core.secp256k1 import GENERATOR, Point
from ..telemetry.spans import get_tracer
from ..utils.roofline import ec_scalar_mul_macs, ec_tree_sum_macs
from . import ec_kernels
from .limbs import LIMB_BITS, LIMB_MASK, ints_to_limbs, limbs_to_ints, to_device, wipe_array
from .montgomery import _Reducer, _cond_subtract, _normalize_carries

__all__ = [
    "batch_scalar_mul",
    "batch_generator_mul",
    "generator_muls",
    "batch_msm",
    "points_to_device",
    "device_to_points",
]

_K = 16  # 256 bits / 16-bit limbs
_R = 1 << 256
_R_INV = pow(_R, -1, FIELD_P)

# Montgomery constants for the fixed field prime
_P_LIMBS = ints_to_limbs([FIELD_P], _K)[0]
_N_PRIME = (-pow(FIELD_P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)  # the JAX digit's n'
_P_INV = ints_to_limbs([(-pow(FIELD_P, -1, _R)) % _R], _K)[0]  # -p^{-1} mod R
_ONE_M = ints_to_limbs([_R % FIELD_P], _K)[0]  # 1 in Montgomery form
_B3_M = ints_to_limbs([21 * _R % FIELD_P], _K)[0]  # 3*b = 21

_EC_WINDOW = 4


# ---------------------------------------------------------------------------
# plain versions


@functools.lru_cache(maxsize=64)
def _reducer(rows: int, device: str) -> _Reducer:
    """The plain product's constants for `rows` rows of the modulus p,
    built once per row count and device (a scalar multiplication runs
    about 1,000 products on a handful of row counts)."""
    row = torch.as_tensor(_P_LIMBS.astype(np.int64), device=device)
    inv = torch.as_tensor(_P_INV.astype(np.int64), device=device)
    return _Reducer(row.expand(rows, _K), inv.expand(rows, _K))


def _const_rows(limbs, b, device) -> torch.Tensor:
    return torch.as_tensor(limbs.astype(np.int64), device=device).expand(b, _K)


def _fmul(x, y) -> torch.Tensor:
    """x*y*R^{-1} mod p per row; x, y < p."""
    return _reducer(x.shape[0], str(x.device)).mont_mul(x, y)


def _wide(t) -> torch.Tensor:
    """(B, K) limbs as (B, K + 2) delayed-carry limbs for `_cond_subtract`."""
    return torch.nn.functional.pad(t, (0, 2))


def _fadd(x, y) -> torch.Tensor:
    """x + y mod p per row; x, y < p. The sum is below 2p: one
    conditional subtraction."""
    return _cond_subtract(_wide(x + y), _reducer(x.shape[0], str(x.device)).n_comp)


def _fsub(x, y) -> torch.Tensor:
    """x - y mod p per row as (x + p) - y, in [1, 2p), then one
    conditional subtraction. The difference is formed with non-negative
    limbs as x + p + (2^256 - y) (the complement of y's limbs, plus one),
    normalised, and the 2^256 taken off limb K (where it is 1 or 2)."""
    b = x.shape[0]
    t = _wide(x + _const_rows(_P_LIMBS, b, x.device) + (LIMB_MASK - y))
    t[:, 0] += 1
    t = _normalize_carries(t)
    t[:, _K] -= 1
    return _cond_subtract(t, _reducer(b, str(x.device)).n_comp)


def _padd(p1, p2) -> torch.Tensor:
    """Complete projective addition, Renes-Costello-Batina Alg. 7 (a=0,
    b3 = 21). p1, p2: (B, 3, K) Montgomery-domain (X : Y : Z).

    The statements are the JAX package's, in its order; the independent
    field operations of a step run as one call on stacked rows (every
    row is reduced on its own, so the values are the same), which cuts
    the plain version's launches about fourfold."""
    b = p1.shape[0]
    x1, y1, z1 = p1.unbind(1)
    x2, y2, z2 = p2.unbind(1)
    b3 = _const_rows(_B3_M, 2 * b, p1.device)

    s = _fadd(torch.cat([x1, y1, x1, x2, y2, x2]), torch.cat([y1, z1, z1, y2, z2, z2]))
    # t0 = x1 x2, t1 = y1 y2, t2 = z1 z2, t3 = (x1+y1)(x2+y2),
    # t4 = (y1+z1)(y2+z2), x3 = (x1+z1)(x2+z2)
    t0, t1, t2, t3, t4, x3 = _fmul(torch.cat([x1, y1, z1, s[: 3 * b]]),
                                   torch.cat([x2, y2, z2, s[3 * b :]])).split(b)
    # t0 + t1, t1 + t2, t0 + t2, t0 + t0
    u = _fadd(torch.cat([t0, t1, t0, t0]), torch.cat([t1, t2, t2, t0]))
    # t3 = t3 - (t0 + t1); t4 = t4 - (t1 + t2); y3 = x3 - (t0 + t2)
    t3, t4, y3 = _fsub(torch.cat([t3, t4, x3]), u[: 3 * b]).split(b)
    x3 = _fadd(u[3 * b :], t0)  # (t0 + t0) + t0
    # t2 = b3 t2; y3 = b3 y3
    t2, y3 = _fmul(b3, torch.cat([t2, y3])).split(b)
    z3 = _fadd(t1, t2)
    t1 = _fsub(t1, t2)
    # t3 t1, t4 y3, y3 x3, t1 z3, z3 t4, x3 t3
    m = _fmul(torch.cat([t3, t4, y3, t1, z3, x3]),
              torch.cat([t1, y3, x3, z3, t4, t3])).split(b)
    out_x = _fsub(m[0], m[1])
    out_y, out_z = _fadd(torch.cat([m[2], m[4]]), torch.cat([m[3], m[5]])).split(b)
    return torch.stack([out_x, out_y, out_z], dim=1)


def _identity_rows(b, device) -> torch.Tensor:
    pt = torch.zeros((b, 3, _K), dtype=torch.int64, device=device)
    pt[:, 1, :] = _const_rows(_ONE_M, b, device)
    return pt


def _scalar_mul_kernel(points, scalars, *, scalar_bits) -> torch.Tensor:
    """points: (B, 3, K); scalars: (B, SL) 16-bit limbs. MSB-first 4-bit
    fixed windows: a 16-entry multiples table (15 sequential adds), then
    per window 4 doublings and one masked table add (a sum over all 16
    entries, never an index by the secret digit). The w=0 entry is the
    identity (absorbed by the complete formula), so every window costs
    the same. Returns (B, 3, K) int64."""
    assert scalar_bits % _EC_WINDOW == 0
    points = points.to(torch.int64)
    scalars = scalars.to(torch.int64)
    b = points.shape[0]
    ident = _identity_rows(b, points.device)
    table = [ident, points]
    for _ in range(2, 1 << _EC_WINDOW):
        table.append(_padd(table[-1], points))
    table = torch.stack(table)
    idx = torch.arange(1 << _EC_WINDOW, device=points.device)[:, None, None, None]
    acc = ident
    for wi in range(scalar_bits // _EC_WINDOW):
        shift = scalar_bits - _EC_WINDOW * (wi + 1)
        limb = scalars[:, shift // LIMB_BITS]
        w = (limb >> (shift % LIMB_BITS)) & ((1 << _EC_WINDOW) - 1)
        for _ in range(_EC_WINDOW):
            acc = _padd(acc, acc)
        sel = torch.where(w[None, :, None, None] == idx, table, 0).sum(dim=0)
        acc = _padd(acc, sel)
    return acc


def _tree_sum_kernel(points) -> torch.Tensor:
    """points: (G, M, 3, K), M a power of two -> (G, 3, K) group sums via
    log2(M) levels of complete adds, level by level lhs = the first half
    of each group's rows, rhs = the second."""
    flat = points.to(torch.int64)
    g, m = flat.shape[0], flat.shape[1]
    while m > 1:
        m //= 2
        lhs = flat[:, :m].reshape(g * m, 3, _K)
        rhs = flat[:, m:].reshape(g * m, 3, _K)
        flat = _padd(lhs, rhs).reshape(g, m, 3, _K)
    return flat[:, 0]


# ---------------------------------------------------------------------------
# host <-> device conversion


def points_to_device(points: Sequence[Point], device) -> torch.Tensor:
    """Affine host points -> (B, 3, K) int32 Montgomery-domain projective
    limbs on `device`."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt.infinity:
            xs.append(0)
            ys.append(_R % FIELD_P)
            zs.append(0)
        else:
            xs.append(pt.x * _R % FIELD_P)
            ys.append(pt.y * _R % FIELD_P)
            zs.append(_R % FIELD_P)
    arr = ints_to_limbs(xs + ys + zs, _K).reshape(3, len(points), _K)
    return to_device(np.ascontiguousarray(arr.transpose(1, 0, 2)), device)


def device_to_points(arr) -> List[Point]:
    """(B, 3, K) Montgomery-domain projective limbs -> affine host points.

    Z inverses use Montgomery's batch-inversion chain (one pow(-1) for
    the whole batch): per-row CPython inversion costs about 0.5 ms, the
    chain 3B cheap 256-bit multiplications."""
    a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    b = a.shape[0]
    flat = limbs_to_ints(a.reshape(b * 3, _K))
    zs = [flat[3 * i + 2] * _R_INV % FIELD_P for i in range(b)]
    # prefix-product chain, skipping identity rows (z == 0)
    prefix = [1] * (b + 1)
    for i, z in enumerate(zs):
        prefix[i + 1] = prefix[i] * (z or 1) % FIELD_P
    acc = pow(prefix[b], -1, FIELD_P)
    zinvs = [0] * b
    for i in range(b - 1, -1, -1):
        zinvs[i] = prefix[i] * acc % FIELD_P
        acc = acc * (zs[i] or 1) % FIELD_P
    out = []
    for i in range(b):
        if zs[i] == 0:
            out.append(Point.identity())
        else:
            x = flat[3 * i] * _R_INV % FIELD_P
            y = flat[3 * i + 1] * _R_INV % FIELD_P
            out.append(Point(x * zinvs[i] % FIELD_P, y * zinvs[i] % FIELD_P))
    return out


def _scalars_to_limbs(scalars: Sequence[int], scalar_bits: int) -> np.ndarray:
    """Returns the NUMPY staging array: callers upload it and wipe it
    (and the uploaded tensor) with wipe_array once the dependent results
    have been downloaded. EC scalars are key shares and prover nonces
    (SECURITY.md)."""
    sl = -(-scalar_bits // LIMB_BITS)
    return ints_to_limbs([s % CURVE_ORDER for s in scalars], sl)


# ---------------------------------------------------------------------------
# public batch entry points


def _pad_pow2(rows: int, floor: int = 8) -> int:
    return max(floor, 1 << (rows - 1).bit_length())


@contextlib.contextmanager
def _staged_scalars(scalars: Sequence[int], scalar_bits: int, device):
    """The scalars as an int32 limb tensor on `device`; on exit (after
    the caller has downloaded the results that depend on them) both the
    numpy staging array and the tensor are wiped."""
    sc_limbs = _scalars_to_limbs(scalars, scalar_bits)
    sc = None
    try:
        sc = to_device(sc_limbs, device)
        yield sc
    finally:
        wipe_array(sc_limbs, sc)


def batch_scalar_mul(
    points: Sequence[Point], scalars: Sequence[int], scalar_bits: int = 256, *, device
) -> List[Point]:
    """Row-wise scalar * point, one launch on `device`. Scalars are
    reduced mod the group order; scalar_bits picks the kernel depth (128
    suffices for random-linear-combination weights). Rows are padded to
    a power of two, at least 8, with identity points."""
    if not points:
        return []
    if len(points) != len(scalars):
        raise ValueError(f"length mismatch: {len(points)} points, {len(scalars)} scalars")
    rows = len(points)
    pad = _pad_pow2(rows) - rows
    pts = list(points) + [Point.identity()] * pad
    scs = [s % CURVE_ORDER for s in scalars] + [0] * pad
    get_tracer().add_macs(ec_scalar_mul_macs(len(pts), scalar_bits))
    with _staged_scalars(scs, scalar_bits, device) as sc:
        out = ec_kernels.scalar_mul(points_to_device(pts, device), sc, scalar_bits)
        return device_to_points(out)[:rows]  # waits for the kernel


def batch_generator_mul(scalars: Sequence[int], *, device) -> List[Point]:
    """s_i * G row-wise, one launch: the prover's fan-outs (the Feldman
    coefficient commitments, S_i = sigma_i * G, reference
    refresh_message.rs:67-69, and the PDL prover's u1 column)."""
    return batch_scalar_mul([GENERATOR] * len(scalars), scalars, device=device)


def generator_muls(scalars: Sequence[int], device) -> List[Point]:
    """s_i * G row-wise: one `batch_generator_mul` launch on `device`, or
    on the host (`core.secp256k1`) when device is None."""
    if device is None:
        return [GENERATOR * s for s in scalars]
    return batch_generator_mul(scalars, device=device)


def batch_msm(
    groups_points: Sequence[Sequence[Point]],
    groups_scalars: Sequence[Sequence[int]],
    scalar_bits: int = 256,
    *,
    device,
) -> List[Point]:
    """Per-group multi-scalar multiplication: sum_i s_i * P_i for each
    group, as ONE scalar-mul launch over all rows plus one tree-sum
    launch. Groups are padded to a common power-of-two size with
    identity points."""
    if not groups_points:
        return []
    if len(groups_points) != len(groups_scalars):
        raise ValueError(
            f"{len(groups_points)} point groups, {len(groups_scalars)} scalar groups"
        )
    g = len(groups_points)
    m_max = max(len(p) for p in groups_points)
    m_pad = _pad_pow2(max(1, m_max), floor=1)

    pts: List[Point] = []
    scs: List[int] = []
    for gp, gs in zip(groups_points, groups_scalars):
        if len(gp) != len(gs):
            raise ValueError(
                f"group length mismatch: {len(gp)} points, {len(gs)} scalars"
            )
        pts.extend(list(gp) + [Point.identity()] * (m_pad - len(gp)))
        scs.extend([s % CURVE_ORDER for s in gs] + [0] * (m_pad - len(gs)))

    get_tracer().add_macs(ec_scalar_mul_macs(len(pts), scalar_bits)
                          + ec_tree_sum_macs(len(pts), g))
    with _staged_scalars(scs, scalar_bits, device) as sc:
        prods = ec_kernels.scalar_mul(points_to_device(pts, device), sc, scalar_bits)
        sums = ec_kernels.tree_sum(prods.view(g, m_pad, 3, _K))
        return device_to_points(sums)  # waits for both kernels
