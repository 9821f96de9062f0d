"""The two hand-written Hopper kernels of the RNS route, their plain
PyTorch versions, the build/loader, and launch counters.

`mont_mul` (kernel 1) — one RNS Montgomery product x*y*A^{-1} mod N per
    row. Replaces `fsdkr_tpu/ops/pallas_rns.py:184` `rns_mont_mul_pallas`.
`modexp` (kernel 2) — base^exp per row, the whole 4-bit fixed-window loop
    in one launch. Replaces `fsdkr_tpu/ops/pallas_rns.py:317`
    `rns_modexp_pallas`.

Both kernels live in `csrc/rns_kernels.cu` (CUDA C++ for sm_90a; its
header comment gives the design) and share one implementation of the
product: a block holds a tile of 8 rows (4 in kernel 2 at the 7168-bit
class) and runs the two base extensions (2*k*(k+1) multiply-adds per
product per row; k = 131 at the 2048-bit class, 260 at 4096) on the
tensor cores as four exact u8 x u8 -> s32 `mma.sync.m16n8k32` plane
products. Both take T1/T2 as u8 low/high planes in the MMA's A-fragment
order (`fragment_planes`), the fold constant u = 2^16 mod m of every
channel (`u_all`), and the number of folds each reduction site needs in
this width class (`fold_counts`): they reduce by folding, never with %.

- Kernel 1 is one product per tile. Its bound on the H100 is bytes (5.2
  us at k=131 and 4096 rows); at 256 rows the bound (0.36 us) is far
  below a launch's own latency, which is the floor there. Its launcher
  picks the warps per block from the number of tiles, so that a launch
  runs in one wave of blocks.
- Kernel 2 keeps its window table and accumulator in shared memory for
  the whole loop, so device memory sees each row's inputs once and its
  result once.

Tensors crossing the kernel boundary are int32 holding values < 2^16
(the planes: uint8). The wrapper dispatches on the tensor's device: a CPU
tensor runs the plain version (the CPU tests' path); a CUDA tensor
launches the kernel or raises — there is no fallback from the kernel to
the plain version. The plain versions compute in int64 with float64
matmuls (exact: every product < 2^32, every sum over at most the
kernels' largest k, 2,065 terms, < 2^44 < 2^53); on the card they are
the reference the kernels are held against, bit for bit.

The library is built at first use with nvcc into `build/` beside the
package (route (b): a plain C interface loaded with ctypes), and rebuilt
when the source changes. Nothing is built or imported at module import.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .nvcc_build import CSRC, build_library

__all__ = [
    "RNSConsts",
    "mont_mul",
    "modexp",
    "mont_mul_plain",
    "modexp_plain",
    "launch_counts",
    "reset_launch_counts",
    "load_library",
    "fold_counts",
    "fragment_planes",
    "tile_smem_bytes",
]

_SRC = CSRC / "rns_kernels.cu"
_SMEM_LIMIT = 232448  # shared memory one block may use on the H100

WINDOW_BITS = 4
# u16 (rows, 2k+1) tiles a block holds: kernel 2 its window table and
# accumulator, kernel 1 its x (then the result) and y
MODEXP_ARRAYS = 17
MONT_MUL_ARRAYS = 2


def tile_smem_bytes(k: int, rt: int, arrays: int) -> int:
    """A block's shared memory for a tile of rt rows holding `arrays` u16
    tiles (the mirror of `Layout::bytes` in csrc/rns_kernels.cu): four u8
    planes (xi and zeta, low and high) of 8 rows x (k rounded up to 32, +
    16), 16 u32 (beta and the windows), and u16 arrays: `arrays` tiles
    (rt, 2k+1) and d in B | m_r (rt, k+1)."""
    sp = -(-k // 32) * 32 + 16
    return 4 * 8 * sp + 64 + 2 * (arrays * rt * (2 * k + 1) + rt * (k + 1))


def _max_k(rt: int, arrays: int) -> int:
    return max(k for k in range(1, 4096) if tile_smem_bytes(k, rt, arrays) <= _SMEM_LIMIT)


# the widest class each kernel's tile admits: kernel 2 at 4 rows per block
# (739; the 7168-bit class has k=454), kernel 1 at 8 (2,065)
_MAX_K_MODEXP = _max_k(4, MODEXP_ARRAYS)
_MAX_K_MONT_MUL = _max_k(8, MONT_MUL_ARRAYS)


def _fold_max(v: int, u: int) -> int:
    """The largest fold (x >> 16) * u + (x & 0xFFFF) over 0 <= x <= v."""
    hi, lo = v >> 16, v & 0xFFFF
    best = hi * u + lo
    return max(best, (hi - 1) * u + 0xFFFF) if hi else best


def _folds_until(v: int, u: int, done) -> Tuple[int, int]:
    """Folds that bring any value <= v to a bound for which done(bound)
    holds: (count, bound)."""
    n = 0
    while not done(v):
        nv = _fold_max(v, u)
        if nv >= v:
            raise ValueError(f"folding by u={u} makes no progress at {v}")
        v, n = nv, n + 1
    return n, v


def fold_counts(m_all, k: int) -> Tuple[int, int, int, int]:
    """Folds per reduction site of the kernels for one width class, from the
    real bounds of every channel prime m (u = 2^16 mod m), the largest
    over the channels: (f_mul, f_mid, f_hh, f_ext).

    - f_mul: a product a*b of residues, <= (m-1)^2, to below 2m.
    - The extension combine, from four u8-plane sums over k terms, each
      <= P = k*255^2: f_mid folds P_lh + P_hl (<= 2P) to mid with
      2^8*mid + P < 2^32; v = P_ll + 2^8*mid; f_hh folds P_hh to hh with
      fold(v) + u*hh < 2^32 (2^16 == u mod m); f_ext folds that sum w to
      below 2m.
    Each site then ends with one conditional subtraction."""
    p = k * 255 * 255
    if 2 * p >= 1 << 32:
        raise ValueError(f"k={k}: the plane sums overflow 32 bits")
    out = [0, 0, 0, 0]
    for m in (int(x) for x in m_all):
        u = (1 << 16) % m
        f_mul, _ = _folds_until((m - 1) ** 2, u, lambda b: b < 2 * m)
        f_mid, mid = _folds_until(2 * p, u, lambda b: (b << 8) + p < 1 << 32)
        fv = _fold_max(p + (mid << 8), u)
        f_hh, hh = _folds_until(p, u, lambda b: fv + u * b < 1 << 32)
        f_ext, _ = _folds_until(fv + u * hh, u, lambda b: b < 2 * m)
        out = [max(a, b) for a, b in zip(out, (f_mul, f_mid, f_hh, f_ext))]
    return tuple(out)


def fragment_planes(T: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A (k, k+1) extension matrix of 16-bit values -> its (lo, hi) u8
    planes, flat, as the kernels load them: the MMA's A operand is T^T
    (k+1 target channels on M, k source channels on K), zero-padded to
    Mp = k+1 rounded up to 16 and Kp = k rounded up to 32, in the
    fragment order of mma.m16n8k32 with 8-bit A (PTX ISA). With
    KT = Kp/32, byte

        ((mt * KT + kt) * 32 + lane) * 16 + i      (mt < Mp/16, kt < KT)

    holds T^T[16 mt + lane//4 + 8 ((i//4) % 2),
              32 kt + 4 (lane % 4) + (i % 4) + 16 (i // 8)],

    so lane `lane` loads its 16 bytes of tile (mt, kt) with one 16-byte
    load."""
    T = np.asarray(T, np.int64)
    k = T.shape[0]
    mp, kp = -(-(k + 1) // 16) * 16, -(-k // 32) * 32
    a = np.zeros((mp, kp), np.int64)
    a[: k + 1, :k] = T.T
    mt, kt, lane, i = np.meshgrid(
        np.arange(mp // 16), np.arange(kp // 32), np.arange(32), np.arange(16),
        indexing="ij",
    )
    rows = 16 * mt + lane // 4 + 8 * ((i // 4) % 2)
    cols = 32 * kt + 4 * (lane % 4) + i % 4 + 16 * (i // 8)
    flat = a[rows, cols].reshape(-1)
    return (flat & 0xFF).astype(np.uint8), (flat >> 8).astype(np.uint8)


@dataclass
class RNSConsts:
    """Shared per-width-class constants on one device (int32, < 2^16):
    m_all (2k+1,), T1 and T2 (k, k+1), Ainv_B (k+1,), c2_B (k,),
    B_mod_A (k,), and the scalar Binv_r. The kernels read T1/T2 as uint8
    planes T1_lo, T1_hi, T2_lo, T2_hi (`fragment_planes`) and also u_all
    (2k+1,) = 2^16 mod m and the fold counts `folds` (`fold_counts`); the
    plain versions read T1 and T2."""

    k: int
    m_all: torch.Tensor
    T1: torch.Tensor
    T2: torch.Tensor
    Ainv_B: torch.Tensor
    c2_B: torch.Tensor
    B_mod_A: torch.Tensor
    Binv_r: int
    u_all: torch.Tensor
    T1_lo: torch.Tensor
    T1_hi: torch.Tensor
    T2_lo: torch.Tensor
    T2_hi: torch.Tensor
    folds: Tuple[int, int, int, int]
    _i64: Dict[str, torch.Tensor] = field(default_factory=dict, repr=False)

    def i64(self, name: str) -> torch.Tensor:
        """int64 copy of a constant, cached (the plain versions' type)."""
        if name not in self._i64:
            self._i64[name] = getattr(self, name).to(torch.int64)
        return self._i64[name]


# ---------------------------------------------------------------------------
# plain PyTorch versions


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of non-negative int64 matrices whose every
    dot product stays below 2^53 — float64 carries it exactly (CUDA's
    matmul takes no integer types)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def _mont_mul_i64(x, y, c1, nbmr, K: RNSConsts):
    k = K.k
    m = K.i64("m_all")
    mA, mBr, mB = m[:k], m[k:], m[k : 2 * k]
    mAr = torch.cat([m[:k], m[2 * k :]])
    d = x * y % m
    xi = d[:, :k] * c1 % mA
    q = exact_matmul(xi, K.i64("T1")) % mBr  # (R, k+1) in B | m_r
    t = (q * nbmr + d[:, k:]) % mBr
    r_Bmr = t * K.i64("Ainv_B") % mBr
    zeta = r_Bmr[:, :k] * K.i64("c2_B") % mB
    s = exact_matmul(zeta, K.i64("T2")) % mAr  # (R, k+1) in A | m_r
    # exact Shenoy correction from the redundant channel
    m_r = m[2 * k]
    beta = (s[:, k] - r_Bmr[:, k]) % m_r * K.Binv_r % m_r  # (R,), < k
    corr = beta[:, None] * K.i64("B_mod_A") % mA
    r_A = (s[:, :k] - corr) % mA
    return torch.cat([r_A, r_Bmr], dim=1)


def mont_mul_plain(x, y, c1, nbmr, K: RNSConsts) -> torch.Tensor:
    """Plain version of kernel 1: (R, 2k+1) int32 residues in, out."""
    return _mont_mul_i64(
        x.to(torch.int64), y.to(torch.int64), c1.to(torch.int64),
        nbmr.to(torch.int64), K,
    ).to(torch.int32)


def modexp_plain(base_res, exp, a2n_res, c1, nbmr, K: RNSConsts,
                 exp_bits: int) -> torch.Tensor:
    """Plain version of kernel 2: the same window loop, the same
    one-hot masked select over all 16 table entries."""
    c1 = c1.to(torch.int64)
    nbmr = nbmr.to(torch.int64)
    exp = exp.to(torch.int64)

    def mul(a, b):
        return _mont_mul_i64(a, b, c1, nbmr, K)

    a2n = a2n_res.to(torch.int64)
    one = torch.ones_like(a2n)
    base_m = mul(base_res.to(torch.int64), a2n)
    one_m = mul(one, a2n)
    table = [one_m, base_m]
    for _ in range(2, 1 << WINDOW_BITS):
        table.append(mul(table[-1], base_m))
    table = torch.stack(table)  # (16, R, C)
    idx = torch.arange(1 << WINDOW_BITS, device=exp.device)[:, None, None]
    acc = one_m
    for wi in range(exp_bits // WINDOW_BITS):
        shift = exp_bits - WINDOW_BITS * (wi + 1)
        w = (exp[:, shift // 16] >> (shift % 16)) & ((1 << WINDOW_BITS) - 1)
        for _ in range(WINDOW_BITS):
            acc = mul(acc, acc)
        sel = (table * (w[None, :, None] == idx)).sum(dim=0)
        acc = mul(acc, sel)
    return mul(acc, one).to(torch.int32)


# ---------------------------------------------------------------------------
# build / load

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()  # threads making the first launch build and load once
build_info: dict = {}  # so path, build seconds, nvcc's -Xptxas -v report


def load_library() -> ctypes.CDLL:
    """Build (if the source hash has no library yet) and load the kernels."""
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _load()
    return _LIB


def _load() -> None:
    global _LIB
    build_info.update(build_library(_SRC))
    lib = ctypes.CDLL(build_info["so"])
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.fsdkr_rns_mont_mul.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, p, p, u, i, ctypes.POINTER(i), i, p, p,
    ]
    lib.fsdkr_rns_mont_mul.restype = i
    lib.fsdkr_rns_modexp.argtypes = [
        p, p, i, i, p, p, p, p, p, p, p, p, p, p, p, p, u, i,
        ctypes.POINTER(i), i, p, p,
    ]
    lib.fsdkr_rns_modexp.restype = i
    _LIB = lib


# ---------------------------------------------------------------------------
# wrappers


def _check(name, t, rows, width, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != rows or t.shape[1] != width:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({rows}, {width})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_consts(K: RNSConsts, device, max_k: int):
    k = K.k
    if not 0 < k <= max_k:
        raise ValueError(f"k={k} outside the kernel's 1..{max_k}")
    for name, shape in (
        ("m_all", (2 * k + 1,)), ("T1", (k, k + 1)), ("T2", (k, k + 1)),
        ("Ainv_B", (k + 1,)), ("c2_B", (k,)), ("B_mod_A", (k,)),
        ("u_all", (2 * k + 1,)),
    ):
        t = getattr(K, name)
        if t.device != device or t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"constant {name} must be int32 {shape} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"constant {name} must be contiguous")
    plane = (-(-(k + 1) // 16) * 16) * (-(-k // 32) * 32)
    for name in ("T1_lo", "T1_hi", "T2_lo", "T2_hi"):
        t = getattr(K, name)
        if t.device != device or t.dtype != torch.uint8 or tuple(t.shape) != (plane,):
            raise ValueError(f"constant {name} must be uint8 ({plane},) on {device}")


def _const_args(K: RNSConsts):
    """The product's constants as the C entry points take them."""
    return (
        K.m_all.data_ptr(), K.u_all.data_ptr(), K.T1_lo.data_ptr(),
        K.T1_hi.data_ptr(), K.T2_lo.data_ptr(), K.T2_hi.data_ptr(),
        K.Ainv_B.data_ptr(), K.c2_B.data_ptr(), K.B_mod_A.data_ptr(),
        K.Binv_r, K.k, (ctypes.c_int * 4)(*K.folds),
    )


def mont_mul(x, y, c1, nbmr, K: RNSConsts) -> torch.Tensor:
    """Kernel 1: x*y*A^{-1} mod N per row over (R, 2k+1) residues."""
    rows, k = x.shape[0], K.k
    device = x.device
    for name, t, w in (("x", x, 2 * k + 1), ("y", y, 2 * k + 1),
                       ("c1", c1, k), ("nbmr", nbmr, k + 1)):
        _check(name, t, rows, w, device)
    _check_consts(K, device, _MAX_K_MONT_MUL)
    if device.type == "cpu":
        return mont_mul_plain(x, y, c1, nbmr, K)
    if device.type != "cuda":
        raise ValueError(f"no RNS kernel for device {device}")
    out = torch.empty_like(x)
    err = load_library().fsdkr_rns_mont_mul(
        x.data_ptr(), y.data_ptr(), c1.data_ptr(), nbmr.data_ptr(),
        *_const_args(K), rows, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fsdkr_rns_mont_mul launch failed: CUDA error {err}")
    mont_mul.launches += 1
    mont_mul.shapes[(k, rows)] = mont_mul.shapes.get((k, rows), 0) + 1
    return out


def modexp(base_res, exp, a2n_res, c1, nbmr, K: RNSConsts,
           exp_bits: int) -> torch.Tensor:
    """Kernel 2: base^exp mod N per row (residues in and out); exp holds
    16-bit limbs, exp_bits is the bucketed loop width (multiple of 4)."""
    rows, k = base_res.shape[0], K.k
    device = base_res.device
    if exp_bits <= 0 or exp_bits % WINDOW_BITS or exp.shape[-1] * 16 < exp_bits:
        raise ValueError(f"exp_bits={exp_bits} does not fit the exponent limbs")
    for name, t, w in (("base_res", base_res, 2 * k + 1),
                       ("exp", exp, exp.shape[-1]),
                       ("a2n_res", a2n_res, 2 * k + 1),
                       ("c1", c1, k), ("nbmr", nbmr, k + 1)):
        _check(name, t, rows, w, device)
    _check_consts(K, device, _MAX_K_MODEXP)
    if device.type == "cpu":
        return modexp_plain(base_res, exp, a2n_res, c1, nbmr, K, exp_bits)
    if device.type != "cuda":
        raise ValueError(f"no RNS kernel for device {device}")
    lib = load_library()
    out = torch.empty_like(base_res)
    err = lib.fsdkr_rns_modexp(
        base_res.data_ptr(), exp.data_ptr(), exp.shape[1], exp_bits,
        a2n_res.data_ptr(), c1.data_ptr(), nbmr.data_ptr(), *_const_args(K),
        rows, out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fsdkr_rns_modexp launch failed: CUDA error {err}")
    modexp.launches += 1
    modexp.shapes[(k, rows, exp_bits)] = modexp.shapes.get((k, rows, exp_bits), 0) + 1
    return out


# launch counters: bumped where a kernel launches and nowhere else; the
# shapes maps let a measurement time each kernel at the shapes a run used
mont_mul.launches = 0
mont_mul.shapes = {}  # (k, rows) -> launches
modexp.launches = 0
modexp.shapes = {}  # (k, rows, exp_bits) -> launches


def launch_counts() -> dict:
    return {"rns_mont_mul": mont_mul.launches, "rns_modexp": modexp.launches}


def reset_launch_counts() -> None:
    mont_mul.launches = 0
    mont_mul.shapes = {}
    modexp.launches = 0
    modexp.shapes = {}
