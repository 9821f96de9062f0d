"""The hand-written Hopper kernels of device EC, their wrappers, loader
and launch counters.

The JAX package's EC kernels (`fsdkr_tpu/ops/ec_batch.py`) are XLA
functions: a scalar multiplication of about 335 complete additions, each
14 field products, that XLA fuses into one program. In eager PyTorch
that would be hundreds of thousands of launches, so each is one kernel
here (`csrc/ec_kernels.cu`, CUDA C++ for sm_90a; its header comment
gives the design):

`scalar_mul` — k*P per row over secp256k1 (replaces `_scalar_mul_kernel`,
    `fsdkr_tpu/ops/ec_batch.py:136`): a row on 8 lanes of a warp, which
    run each complete addition's independent products side by side (one
    product a lane a round) and exchange the sums between rounds by
    shuffles; 4 rows a one-warp block, the 16-entry window table in
    shared memory.
`tree_sum` — each group's rows summed by log2(M) levels of complete
    additions (replaces `_tree_sum_kernel`, :175): one block a group,
    one thread a pair, the levels in a global scratch buffer.

Both run the field arithmetic of p = 2^256 - 2^32 - 977 on 8 32-bit
words: a Montgomery reduction on p's special form, squarings in the
doublings, the products by b3 and 3 as products by small constants.

Points are (rows, 3, 16) int32 tensors of canonical 16-bit limbs of the
Montgomery-domain projective coordinates (R = 2^256, every value below
p); scalars (rows, SL) int32 16-bit limbs, reduced mod the group order,
scalar_bits a positive multiple of 4 with SL * 16 >= scalar_bits. The
wrapper dispatches on the tensor's device: a CPU tensor runs the plain
version (`ops.ec_batch`); a CUDA tensor launches the kernel or raises.
The library is built at first use with nvcc (`ops.nvcc_build`) and
rebuilt when the source changes.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .nvcc_build import CSRC, build_library

__all__ = [
    "scalar_mul",
    "tree_sum",
    "launch_counts",
    "reset_launch_counts",
    "load_library",
]

_SRC = CSRC / "ec_kernels.cu"
_K = 16  # 16-bit limbs of a field element
WINDOW_BITS = 4

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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fsdkr_ec_scalar_mul.argtypes = [p, p, i, i, i, p, p]
    lib.fsdkr_ec_scalar_mul.restype = i
    lib.fsdkr_ec_tree_sum.argtypes = [p, i, i, p, p, p]
    lib.fsdkr_ec_tree_sum.restype = i
    _LIB = lib


def _check(name, t, shape):
    """One int32 tensor of the given shape, contiguous, on the CPU or a
    CUDA device."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no EC kernel for device {t.device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _count(fn, shape):
    fn.launches += 1
    fn.shapes[shape] = fn.shapes.get(shape, 0) + 1


def scalar_mul(points, scalars, scalar_bits: int) -> torch.Tensor:
    """k*P per row: points (rows, 3, 16), scalars (rows, SL) limbs ->
    (rows, 3, 16) projective limbs. The MSB-first 4-bit fixed-window loop
    over scalar_bits bits, every window's table entry chosen by a masked
    sum over all 16."""
    if points.dim() != 3 or scalars.dim() != 2:
        raise ValueError(f"points {tuple(points.shape)} and scalars {tuple(scalars.shape)}: "
                         f"expected (rows, 3, {_K}) and (rows, SL)")
    rows, sl = points.shape[0], scalars.shape[1]
    _check("points", points, (rows, 3, _K))
    _check("scalars", scalars, (rows, sl))
    if scalars.device != points.device:
        raise ValueError(f"scalars on {scalars.device}, points on {points.device}")
    if scalar_bits <= 0 or scalar_bits % WINDOW_BITS or sl * 16 < scalar_bits:
        raise ValueError(f"scalar_bits={scalar_bits} does not fit {sl} scalar limbs")
    if rows == 0:
        raise ValueError("no rows")
    if points.device.type == "cpu":
        from .ec_batch import _scalar_mul_kernel

        return _scalar_mul_kernel(points, scalars, scalar_bits=scalar_bits).to(torch.int32)
    out = torch.empty_like(points)
    err = load_library().fsdkr_ec_scalar_mul(
        points.data_ptr(), scalars.data_ptr(), rows, sl, scalar_bits,
        out.data_ptr(), _stream(points.device))
    if err:
        raise RuntimeError(f"fsdkr_ec_scalar_mul launch failed: CUDA error {err}")
    _count(scalar_mul, (rows, scalar_bits))
    return out


def tree_sum(points) -> torch.Tensor:
    """(G, M, 3, 16) projective limbs, M a power of two -> (G, 3, 16) group
    sums: log2(M) levels of complete additions, at each level row i of
    the first half plus row i of the second."""
    if points.dim() != 4:
        raise ValueError(f"points has shape {tuple(points.shape)}, expected (G, M, 3, {_K})")
    g, m = points.shape[0], points.shape[1]
    _check("points", points, (g, m, 3, _K))
    if g == 0 or m == 0 or m & (m - 1):
        raise ValueError(f"{g} groups of {m} rows: the tree takes groups of 2^j rows")
    if points.device.type == "cpu":
        from .ec_batch import _tree_sum_kernel

        return _tree_sum_kernel(points).to(torch.int32)
    out = torch.empty((g, 3, _K), dtype=torch.int32, device=points.device)
    # the levels' sums, 8 32-bit words a coordinate
    scratch = torch.empty((g, max(m // 2, 1), 3 * _K // 2), dtype=torch.int32,
                          device=points.device)
    err = load_library().fsdkr_ec_tree_sum(
        points.data_ptr(), g, m, scratch.data_ptr(), out.data_ptr(), _stream(points.device))
    if err:
        raise RuntimeError(f"fsdkr_ec_tree_sum launch failed: CUDA error {err}")
    _count(tree_sum, (g, m))
    return out


# launch counters: bumped where a kernel launches and nowhere else; the
# shapes maps let a measurement time each kernel at the shapes a run used
scalar_mul.launches = 0
scalar_mul.shapes = {}  # (rows, scalar_bits) -> launches
tree_sum.launches = 0
tree_sum.shapes = {}  # (groups, rows per group) -> launches


def launch_counts() -> dict:
    return {"ec_scalar_mul": scalar_mul.launches, "ec_tree_sum": tree_sum.launches}


def reset_launch_counts() -> None:
    for fn in (scalar_mul, tree_sum):
        fn.launches = 0
        fn.shapes = {}
