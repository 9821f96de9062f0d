"""The hand-written Hopper kernels of the CIOS engine, their wrappers,
loader and launch counters.

The JAX package's CIOS engine (`fsdkr_tpu/ops/montgomery.py`) is XLA
code: a K-step loop per Montgomery product that XLA fuses into one
program. In eager PyTorch that loop would be K launches per product, so
each engine entry point is one kernel here (`csrc/cios_kernels.cu`, CUDA
C++ for sm_90a; its header comment gives the design):

`mont_mul` — x*y*R^{-1} mod n per row (replaces `mont_mul_limbs`,
    `fsdkr_tpu/ops/montgomery.py:102`; it also serves the inverse tree's
    levels and its exit, :792-917).
`modmul` — a*b mod n per row, the two products of `_modmul_kernel`
    (:606) in one launch, on the sub-warp product at every size (from
    the rule's rows, `rows_rule`, at `mont_mul`'s lanes a row).
`modexp_segments` — base^exp mod n per row, the whole 4-bit fixed-window
    loop of `_modexp_kernel` (:137), over several segments (each with its
    own K, rows, exponent width and tensors) in one launch; `modexp` is
    its one-segment call.
`comb` — the fixed-base comb's accumulation and exit, one launch: per
    row, one masked 16-entry table select and product per window, then
    the product by 1 (`_shared_modexp_kernel` :372-446). Several rows a
    warp on the sub-warp product (L lanes a row), the group's window
    entries staged in shared memory; `mont_mul` takes the same product
    at launches of at least the rule's rows (`rows_rule`).
`comb_ladder` — the comb's power ladder base_m^(16^w) (:323-336), one
    block a group on a full-width-digit Montgomery product (three
    block-wide multi-precision products a step, at the rule's threads a
    block, `ladder_rule`). The table between the two is four `mont_mul`
    launches (`ops.montgomery._comb_table`).
`multi_modexp` — the joint (Straus) product prod_t base_t^exp_t mod n
    per row of `_multi_modexp_kernel` (:450): T window tables, one shared
    chain of four squarings and one masked table product per active term
    a window. One block a row on the ladder's block product, the tables
    in its shared memory (`multi_modexp_max_terms`), at the rule's
    threads a block; launches of more rows than the rule's take one warp
    a row on the CIOS product (`joint_rule`).
`shared_exp_segments` — base^E mod n per row for one shared public
    exponent E a segment, given as its 4-bit digits (`_shared_exp_kernel`,
    :183), each segment with its own modulus, over several segments in one
    launch as `modexp_segments` takes them; on the same row bodies and
    rule as `multi_modexp`.

Tensors crossing the kernel boundary are int32 (rows, K) of canonical
16-bit limbs, K even (R = 2^(16K) on a 32-bit word), 2 <= K <= 1024;
exponents are (rows, EL) limbs with exp_bits from `bucket_exp_bits`;
n_inv = -n^{-1} mod R (`MontgomeryContext.n_inv`), of which the kernels
read the low 32 bits. The wrapper dispatches on the tensor's device: a
CPU tensor runs the plain version (`ops.montgomery`); a CUDA tensor
launches the kernel or raises. The library is built at first use with
nvcc (`ops.nvcc_build`) and rebuilt when the source changes.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

import torch

from .nvcc_build import CSRC, build_library

__all__ = [
    "mont_mul",
    "modmul",
    "modexp",
    "modexp_segments",
    "comb",
    "comb_ladder",
    "comb_at_lanes",
    "mont_mul_at_lanes",
    "modmul_at_lanes",
    "comb_ladder_at_threads",
    "rows_rule",
    "ladder_rule",
    "multi_modexp",
    "multi_modexp_at_threads",
    "multi_modexp_max_terms",
    "joint_rule",
    "shared_exp_segments",
    "shared_exp_at_threads",
    "launch_counts",
    "reset_launch_counts",
    "load_library",
    "MAX_LIMBS",
    "MAX_SEGMENTS",
]

_SRC = CSRC / "cios_kernels.cu"
MAX_LIMBS = 1024  # 16 words a lane: 16384-bit moduli
MAX_SEGMENTS = 32  # segments a modexp launch (its table is the launch's parameter)
_SEGMENT_WORDS = 11  # int64 words a segment in that table (csrc: kSegmentWords)
_SHARED_EXP_WORDS = 10  # a shared-exponent segment's words (csrc: kSharedExpWords)
MAX_TERMS = 16  # terms a Straus launch (csrc: kMaxTerms)
MAX_SMEM_BYTES = 227 * 1024  # a block's opt-in shared memory on the H100 (csrc: kMaxSmemBytes)
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
    lib.fsdkr_cios_mont_mul.argtypes = [p, p, p, p, i, i, p, p]
    lib.fsdkr_cios_mont_mul.restype = i
    lib.fsdkr_cios_modmul.argtypes = [p, p, p, p, p, i, i, p, p]
    lib.fsdkr_cios_modmul.restype = i
    lib.fsdkr_cios_modexp.argtypes = [ctypes.POINTER(ctypes.c_int64), i, p]
    lib.fsdkr_cios_modexp.restype = i
    lib.fsdkr_cios_comb.argtypes = [p, p, i, i, p, p, p, i, i, i, p, p]
    lib.fsdkr_cios_comb.restype = i
    lib.fsdkr_cios_comb_ladder.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.fsdkr_cios_comb_ladder.restype = i
    lib.fsdkr_cios_mont_mul_lanes.argtypes = [i, p, p, p, p, i, i, p, p]
    lib.fsdkr_cios_mont_mul_lanes.restype = i
    lib.fsdkr_cios_comb_lanes.argtypes = [i, p, p, i, i, p, p, p, i, i, i, p, p]
    lib.fsdkr_cios_comb_lanes.restype = i
    lib.fsdkr_cios_rows_rule.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i),
                                         ctypes.POINTER(i)]
    lib.fsdkr_cios_rows_rule.restype = i
    lib.fsdkr_cios_modmul_lanes.argtypes = [i, p, p, p, p, p, i, i, p, p]
    lib.fsdkr_cios_modmul_lanes.restype = i
    lib.fsdkr_cios_comb_ladder_threads.argtypes = [i, p, p, p, p, i, i, i, p, p]
    lib.fsdkr_cios_comb_ladder_threads.restype = i
    lib.fsdkr_cios_ladder_rule.argtypes = [i, ctypes.POINTER(i)]
    lib.fsdkr_cios_ladder_rule.restype = i
    lib.fsdkr_cios_multi_modexp.argtypes = [p, p, i, ctypes.POINTER(i), i, p, p, p, p, i, i,
                                            p, p]
    lib.fsdkr_cios_multi_modexp.restype = i
    lib.fsdkr_cios_shared_exp.argtypes = [ctypes.POINTER(ctypes.c_int64), i, p]
    lib.fsdkr_cios_shared_exp.restype = i
    lib.fsdkr_cios_multi_modexp_threads.argtypes = [i, p, p, i, ctypes.POINTER(i), i, p, p, p,
                                                    p, i, i, p, p]
    lib.fsdkr_cios_multi_modexp_threads.restype = i
    lib.fsdkr_cios_shared_exp_threads.argtypes = [i, ctypes.POINTER(ctypes.c_int64), i, p]
    lib.fsdkr_cios_shared_exp_threads.restype = i
    lib.fsdkr_cios_joint_rule.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.fsdkr_cios_joint_rule.restype = i
    _LIB = lib


def _check(tensors, rows, width):
    """Every (name, tensor) is an int32 (rows, width) contiguous tensor on
    the first one's device; returns that device."""
    device = tensors[0][1].device
    for name, t in tensors:
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        w = width if name != "exp" else t.shape[-1]
        if t.dim() != 2 or t.shape[0] != rows or t.shape[1] != w:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({rows}, {w})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if width < 2 or width % 2 or width > MAX_LIMBS:
        raise ValueError(f"K={width} limbs: the kernels take even K in 2..{MAX_LIMBS}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no CIOS kernel for device {device}")
    return device


def _check_shape(name, t, shape, device):
    """One int32 tensor of the given shape, contiguous, on `device`."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_exp_bits(exp_bits, exp_limbs):
    if exp_bits <= 0 or exp_bits % WINDOW_BITS or exp_limbs * 16 < exp_bits:
        raise ValueError(f"exp_bits={exp_bits} does not fit the exponent limbs")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _count(fn, shape):
    fn.launches += 1
    fn.shapes[shape] = fn.shapes.get(shape, 0) + 1


def rows_rule(k: int):
    """The sub-warp kernels' launch rules at K limbs, as the library holds
    them: (the comb's lanes a row, `mont_mul`'s and `modmul`'s lanes a
    row, the rows from which both take the sub-warp kernel)."""
    out = [ctypes.c_int() for _ in range(3)]
    if load_library().fsdkr_cios_rows_rule(k, *map(ctypes.byref, out)):
        raise ValueError(f"no sub-warp launch rule at K={k}")
    return tuple(v.value for v in out)


def mont_mul(x, y, n, n_inv) -> torch.Tensor:
    """x*y*R^{-1} mod n per row over (rows, K) limbs; x, y < n. On the card
    one warp a row, or from the rule's rows on the sub-warp kernel."""
    return _mont_mul(None, x, y, n, n_inv)


def mont_mul_at_lanes(lanes: int, x, y, n, n_inv) -> torch.Tensor:
    """`mont_mul` on a layout named here, not by the launch rule: lanes 0
    for one warp a row, 8, 16 or 32 for the sub-warp kernel at that many
    lanes a row. For the sweep's mont_mul cells; the engine calls
    `mont_mul`."""
    return _mont_mul(lanes, x, y, n, n_inv)


def _mont_mul(lanes, x, y, n, n_inv):
    rows, k = x.shape
    device = _check((("x", x), ("y", y), ("n", n), ("n_inv", n_inv)), rows, k)
    if device.type == "cpu":
        from .montgomery import mont_mul_limbs

        return mont_mul_limbs(x, y, n, n_inv).to(torch.int32)
    out = torch.empty_like(x)
    lib = load_library()
    args = (x.data_ptr(), y.data_ptr(), n.data_ptr(), n_inv.data_ptr(), rows, k,
            out.data_ptr(), _stream(device))
    err = lib.fsdkr_cios_mont_mul(*args) if lanes is None else \
        lib.fsdkr_cios_mont_mul_lanes(lanes, *args)
    if err:
        raise RuntimeError(f"fsdkr_cios_mont_mul launch failed: CUDA error {err}")
    _count(mont_mul, (k, rows))
    return out


def ladder_rule(k: int) -> int:
    """The ladder's launch rule at K limbs, as the library holds it: its
    threads a block."""
    out = ctypes.c_int()
    if load_library().fsdkr_cios_ladder_rule(k, ctypes.byref(out)):
        raise ValueError(f"no ladder launch rule at K={k}")
    return out.value


def modmul(a, b, n, n_inv, r2) -> torch.Tensor:
    """a*b mod n per row (a, b < n): MontMul(MontMul(a, R^2 mod n), b). On
    the card on the sub-warp kernel: 32 lanes a row, or from the rule's
    rows at `mont_mul`'s lanes."""
    return _modmul(None, a, b, n, n_inv, r2)


def modmul_at_lanes(lanes: int, a, b, n, n_inv, r2) -> torch.Tensor:
    """`modmul` at 8, 16 or 32 lanes a row, named here, not by the launch
    rule. For the sweep's mont_mul cells; the engine calls `modmul`."""
    return _modmul(lanes, a, b, n, n_inv, r2)


def _modmul(lanes, a, b, n, n_inv, r2):
    rows, k = a.shape
    device = _check((("a", a), ("b", b), ("n", n), ("n_inv", n_inv), ("r2", r2)),
                    rows, k)
    if device.type == "cpu":
        from .montgomery import _modmul_kernel

        return _modmul_kernel(a, b, n, n_inv, r2).to(torch.int32)
    out = torch.empty_like(a)
    lib = load_library()
    args = (a.data_ptr(), b.data_ptr(), n.data_ptr(), n_inv.data_ptr(), r2.data_ptr(),
            rows, k, out.data_ptr(), _stream(device))
    err = lib.fsdkr_cios_modmul(*args) if lanes is None else \
        lib.fsdkr_cios_modmul_lanes(lanes, *args)
    if err:
        raise RuntimeError(f"fsdkr_cios_modmul launch failed: CUDA error {err}")
    _count(modmul, (k, rows))
    return out


def modexp(base, exp, n, n_inv, r2, one_mont, exp_bits: int) -> torch.Tensor:
    """base^exp mod n per row (base < n); exp holds 16-bit limbs, exp_bits
    is the bucketed loop width (a multiple of 4). One segment of
    `modexp_segments`."""
    return modexp_segments([(base, exp, n, n_inv, r2, one_mont, exp_bits)])[0]


def modexp_segments(segments) -> List[torch.Tensor]:
    """`modexp` over several segments in one launch: each segment is a
    tuple (base, exp, n, n_inv, r2, one_mont, exp_bits) as `modexp` takes
    it, with its own K, rows and exponent width; all on one device, at
    most MAX_SEGMENTS. Returns each segment's (rows, K) result. On the
    CPU, the plain version per segment."""
    if not segments or len(segments) > MAX_SEGMENTS:
        raise ValueError(f"{len(segments)} segments: a launch takes 1..{MAX_SEGMENTS}")
    device = None
    for seg in segments:
        if len(seg) != 7:
            raise ValueError("a segment is (base, exp, n, n_inv, r2, one_mont, exp_bits)")
        base, exp, n, n_inv, r2, one_mont, exp_bits = seg
        if base.dim() != 2:
            raise ValueError(f"base has shape {tuple(base.shape)}, expected (rows, K)")
        rows, k = base.shape
        d = _check((("base", base), ("exp", exp), ("n", n), ("n_inv", n_inv),
                    ("r2", r2), ("one_mont", one_mont)), rows, k)
        if device is not None and d != device:
            raise ValueError(f"segments on {device} and {d}")
        device = d
        _check_exp_bits(exp_bits, exp.shape[1])
    if device.type == "cpu":
        from .montgomery import _modexp_kernel

        return [_modexp_kernel(base, exp, n, n_inv, r2, one_mont,
                               exp_bits=exp_bits).to(torch.int32)
                for base, exp, n, n_inv, r2, one_mont, exp_bits in segments]
    outs = [torch.empty_like(seg[0]) for seg in segments]
    table = (ctypes.c_int64 * (_SEGMENT_WORDS * len(segments)))()
    for i, ((base, exp, n, n_inv, r2, one_mont, exp_bits), out) in enumerate(
            zip(segments, outs)):
        table[_SEGMENT_WORDS * i : _SEGMENT_WORDS * (i + 1)] = [
            base.data_ptr(), exp.data_ptr(), n.data_ptr(), n_inv.data_ptr(),
            r2.data_ptr(), one_mont.data_ptr(), out.data_ptr(), base.shape[0],
            base.shape[1], exp.shape[1], exp_bits,
        ]
    err = load_library().fsdkr_cios_modexp(table, len(segments), _stream(device))
    if err:
        raise RuntimeError(f"fsdkr_cios_modexp launch failed: CUDA error {err}")
    _count(modexp_segments, tuple((seg[0].shape[1], seg[0].shape[0], seg[6])
                                  for seg in segments))
    return outs


def comb(table, exp, n, n_inv, one_mont, exp_bits: int) -> torch.Tensor:
    """result[g, m] = prod over windows w of table[d_w, w, g], out of the
    Montgomery domain: base[g]^exp[g, m] mod n[g] for the table of
    `ops.montgomery._comb_table`. table: (16, W, G, K) with W =
    exp_bits / 4; exp: (G, M, EL) 16-bit limbs; n, n_inv, one_mont: (G,
    K). Returns (G, M, K)."""
    return _comb(None, table, exp, n, n_inv, one_mont, exp_bits)


def comb_at_lanes(lanes: int, table, exp, n, n_inv, one_mont, exp_bits: int) -> torch.Tensor:
    """`comb` at 8, 16 or 32 lanes a row, named here, not by the launch
    rule: for the lanes sweep; the engine calls `comb`."""
    return _comb(lanes, table, exp, n, n_inv, one_mont, exp_bits)


def _comb(lanes, table, exp, n, n_inv, one_mont, exp_bits):
    g, k = n.shape
    device = _check((("n", n), ("n_inv", n_inv), ("one_mont", one_mont)), g, k)
    if exp.dim() != 3 or exp.shape[0] != g:
        raise ValueError(f"exp has shape {tuple(exp.shape)}, expected ({g}, M, EL)")
    m, el = exp.shape[1], exp.shape[2]
    _check_exp_bits(exp_bits, el)
    w_cnt = exp_bits // WINDOW_BITS
    _check_shape("exp", exp, (g, m, el), device)
    _check_shape("table", table, (1 << WINDOW_BITS, w_cnt, g, k), device)
    if device.type == "cpu":
        from .montgomery import _comb_accumulate

        return _comb_accumulate(table, exp, n, n_inv, one_mont,
                                exp_bits=exp_bits).to(torch.int32)
    if table.data_ptr() % 8:
        raise ValueError("table must be 8-byte aligned (the kernel copies it a word at a time)")
    out = torch.empty((g, m, k), dtype=torch.int32, device=device)
    lib = load_library()
    args = (table.data_ptr(), exp.data_ptr(), el, exp_bits, n.data_ptr(), n_inv.data_ptr(),
            one_mont.data_ptr(), g, m, k, out.data_ptr(), _stream(device))
    err = lib.fsdkr_cios_comb(*args) if lanes is None else \
        lib.fsdkr_cios_comb_lanes(lanes, *args)
    if err:
        raise RuntimeError(f"fsdkr_cios_comb launch failed: CUDA error {err}")
    _count(comb, (k, g, m, exp_bits))
    return out


def comb_ladder(base, n, n_inv, r2, w_cnt: int) -> torch.Tensor:
    """powers[w, g] = base[g]^(16^w) * R mod n[g] for w < w_cnt, the
    comb's ladder in the Montgomery domain; base < n, all (G, K); n_inv
    at full width (the kernel's digit reads all of it). Returns (W, G,
    K)."""
    return _ladder(None, base, n, n_inv, r2, w_cnt)


def comb_ladder_at_threads(threads: int, base, n, n_inv, r2, w_cnt: int) -> torch.Tensor:
    """`comb_ladder` at 256 or 512 threads a block, named here, not
    by the launch rule: for the sweep's ladder cells; the engine calls
    `comb_ladder`."""
    return _ladder(threads, base, n, n_inv, r2, w_cnt)


def _ladder(threads, base, n, n_inv, r2, w_cnt):
    g, k = base.shape
    device = _check((("base", base), ("n", n), ("n_inv", n_inv), ("r2", r2)), g, k)
    if w_cnt <= 0:
        raise ValueError(f"w_cnt={w_cnt}: the ladder takes at least one window")
    if device.type == "cpu":
        from .montgomery import _comb_ladder

        return _comb_ladder(base, n, n_inv, r2, w_cnt).to(torch.int32)
    out = torch.empty((w_cnt, g, k), dtype=torch.int32, device=device)
    lib = load_library()
    args = (base.data_ptr(), n.data_ptr(), n_inv.data_ptr(), r2.data_ptr(), g, k, w_cnt,
            out.data_ptr(), _stream(device))
    err = lib.fsdkr_cios_comb_ladder(*args) if threads is None else \
        lib.fsdkr_cios_comb_ladder_threads(threads, *args)
    if err:
        raise RuntimeError(f"fsdkr_cios_comb_ladder launch failed: CUDA error {err}")
    _count(comb_ladder, (k, g, w_cnt * WINDOW_BITS))
    return out


# the ladder's block product, as csrc lays out its shared memory
# (ladder_parts, ladder_part_words, ladder_smem_words): the joint kernels'
# term cap follows from it
_CHUNK, _PAD = 8, 256


def _ladder_smem_words(w: int, threads: int) -> int:
    s = 1
    while 2 * s <= 32 and 2 * s <= w and 2 * s * w <= threads:
        s *= 2
    i = (-(-w // s) + _CHUNK - 1) // _CHUNK * _CHUNK
    return 8 * (w + 1) + 3 * s * (i + 4) + 5 * (_PAD + 2 * w) + (2 * w + 4) + 128


JOINT_BLOCK_ROWS = 264  # csrc: kJointBlockRows, two blocks a SM on the H100's 132 SMs


def _joint_block_threads(k: int) -> int:
    """The block form's threads at K limbs (csrc: joint_block_threads)."""
    return 256 if k <= 256 else 512


def _joint_threads(k: int, rows: int) -> int:
    """The joint kernels' threads a block at K limbs and `rows` rows, 0 for
    one warp a row (csrc: joint_threads)."""
    return 0 if rows > JOINT_BLOCK_ROWS else _joint_block_threads(k)


def multi_modexp_max_terms(k: int) -> int:
    """The most terms a `multi_modexp` launch at K limbs takes: a row's
    16-entry tables, 16 * K/2 words a term, beside the block product's own
    shared memory, must fit a block's opt-in shared memory, and so must
    one warp's tables in the one-warp form (csrc: joint_max_terms; the
    library refuses more). 16 up to K=256, 12 at K=512, 5 at K=1024."""
    w = k // 2
    room = MAX_SMEM_BYTES // 4 - _ladder_smem_words(w, _joint_block_threads(k))
    p = 1
    while 32 * p < w:
        p *= 2
    return min(MAX_TERMS, room // (16 * w), MAX_SMEM_BYTES // (16 * 32 * 4 * p))


def joint_rule(k: int, rows: int):
    """The joint kernels' launch rule at K limbs and `rows` rows (a
    launch's, all its segments'), as the library holds it: (threads a
    block, 0 for one warp a row; the most terms a `multi_modexp` launch
    takes)."""
    out = [ctypes.c_int() for _ in range(2)]
    if load_library().fsdkr_cios_joint_rule(k, rows, *map(ctypes.byref, out)):
        raise ValueError(f"no joint launch rule at K={k}, {rows} rows")
    return tuple(v.value for v in out)


def multi_modexp(bases, exps, n, n_inv, r2, one_mont, exp_bits_seq) -> torch.Tensor:
    """prod_t bases[t]^exps[t] mod n per row, the joint (Straus) ladder.
    bases: (T, rows, K), each < n; exps: (T, rows, EL) 16-bit limbs;
    n, n_inv, r2, one_mont: (rows, K); exp_bits_seq: each term's loop
    width, a multiple of 4, descending (term t's digits fill the chain's
    last exp_bits_seq[t] / 4 windows). Returns (rows, K). On the card one
    block a row, or one warp a row past the rule's rows (`joint_rule`);
    more terms than `multi_modexp_max_terms` raises."""
    return _multi_modexp(None, bases, exps, n, n_inv, r2, one_mont, exp_bits_seq)


def multi_modexp_at_threads(threads: int, bases, exps, n, n_inv, r2, one_mont,
                            exp_bits_seq) -> torch.Tensor:
    """`multi_modexp` at 256 or 512 threads a block, or one warp a row (0),
    named here, not by the launch rule: for the sweep's joint cells; the
    engine calls `multi_modexp`."""
    return _multi_modexp(threads, bases, exps, n, n_inv, r2, one_mont, exp_bits_seq)


def _multi_modexp(threads, bases, exps, n, n_inv, r2, one_mont, exp_bits_seq):
    if bases.dim() != 3:
        raise ValueError(f"bases has shape {tuple(bases.shape)}, expected (T, rows, K)")
    t_cnt, rows, k = bases.shape
    device = _check((("n", n), ("n_inv", n_inv), ("r2", r2), ("one_mont", one_mont)), rows, k)
    eb = tuple(int(e) for e in exp_bits_seq)
    if not 1 <= t_cnt <= MAX_TERMS or len(eb) != t_cnt:
        raise ValueError(f"{t_cnt} terms with widths {eb}: a launch takes 1..{MAX_TERMS}")
    if list(eb) != sorted(eb, reverse=True):
        raise ValueError(f"exp_bits_seq {eb} is not descending")
    if exps.dim() != 3:
        raise ValueError(f"exps has shape {tuple(exps.shape)}, expected (T, rows, EL)")
    el = exps.shape[2]
    for e in eb:
        _check_exp_bits(e, el)
    _check_shape("bases", bases, (t_cnt, rows, k), device)
    _check_shape("exps", exps, (t_cnt, rows, el), device)
    if device.type == "cpu":
        from .montgomery import _multi_modexp_kernel

        return _multi_modexp_kernel(bases, exps, n, n_inv, r2, one_mont,
                                    exp_bits_seq=eb).to(torch.int32)
    if t_cnt > multi_modexp_max_terms(k):
        raise ValueError(f"{t_cnt} terms at K={k}: the tables would not fit a block "
                         f"(at most {multi_modexp_max_terms(k)})")
    out = torch.empty_like(n)
    widths = (ctypes.c_int * t_cnt)(*eb)
    lib = load_library()
    args = (bases.data_ptr(), exps.data_ptr(), el, widths, t_cnt, n.data_ptr(), n_inv.data_ptr(),
            r2.data_ptr(), one_mont.data_ptr(), rows, k, out.data_ptr(), _stream(device))
    err = lib.fsdkr_cios_multi_modexp(*args) if threads is None else \
        lib.fsdkr_cios_multi_modexp_threads(threads, *args)
    if err:
        raise RuntimeError(f"fsdkr_cios_multi_modexp launch failed: CUDA error {err}")
    _count(multi_modexp, (k, rows, eb))
    return out


def shared_exp_segments(segments) -> List[torch.Tensor]:
    """base^E mod n per row, one public exponent E and one modulus a
    segment, several segments in one launch. A segment is (base, digits,
    n, n_inv, r2, one_mont): base (rows, K), each < n; digits (windows,),
    E's 4-bit window digits most significant first
    (`ops.montgomery.exp_digits`); n, n_inv, r2, one_mont (1, K), the
    segment's modulus. At most MAX_SEGMENTS, all on one device. Returns
    each segment's (rows, K) result. On the card one block a row, or one
    warp a row past the rule's rows (`joint_rule`); on the CPU, the plain
    version per segment."""
    return _shared_exp(None, segments)


def shared_exp_at_threads(threads: int, segments) -> List[torch.Tensor]:
    """`shared_exp_segments` at 256 or 512 threads a block, or one warp a
    row (0), named here, not by the launch rule: for the sweep's joint
    cells; the engine calls `shared_exp_segments`."""
    return _shared_exp(threads, segments)


def _shared_exp(threads, segments):
    if not segments or len(segments) > MAX_SEGMENTS:
        raise ValueError(f"{len(segments)} segments: a launch takes 1..{MAX_SEGMENTS}")
    device = None
    for seg in segments:
        if len(seg) != 6:
            raise ValueError("a segment is (base, digits, n, n_inv, r2, one_mont)")
        base, digits, n, n_inv, r2, one_mont = seg
        if base.dim() != 2:
            raise ValueError(f"base has shape {tuple(base.shape)}, expected (rows, K)")
        k = base.shape[1]
        d = _check((("n", n), ("n_inv", n_inv), ("r2", r2), ("one_mont", one_mont)), 1, k)
        if device is not None and d != device:
            raise ValueError(f"segments on {device} and {d}")
        device = d
        _check_shape("base", base, tuple(base.shape), device)
        if digits.dim() != 1:
            raise ValueError(f"digits has shape {tuple(digits.shape)}, expected (windows,)")
        _check_shape("digits", digits, tuple(digits.shape), device)
    if device.type == "cpu":
        from .montgomery import _shared_exp_kernel

        return [_shared_exp_kernel(*seg).to(torch.int32) for seg in segments]
    outs = [torch.empty_like(seg[0]) for seg in segments]
    table = (ctypes.c_int64 * (_SHARED_EXP_WORDS * len(segments)))()
    for i, ((base, digits, n, n_inv, r2, one_mont), out) in enumerate(zip(segments, outs)):
        table[_SHARED_EXP_WORDS * i : _SHARED_EXP_WORDS * (i + 1)] = [
            base.data_ptr(), digits.data_ptr(), n.data_ptr(), n_inv.data_ptr(), r2.data_ptr(),
            one_mont.data_ptr(), out.data_ptr(), base.shape[0], base.shape[1],
            digits.shape[0],
        ]
    lib = load_library()
    err = lib.fsdkr_cios_shared_exp(table, len(segments), _stream(device)) if threads is None \
        else lib.fsdkr_cios_shared_exp_threads(threads, table, len(segments), _stream(device))
    if err:
        raise RuntimeError(f"fsdkr_cios_shared_exp launch failed: CUDA error {err}")
    _count(shared_exp_segments, tuple((seg[0].shape[1], seg[0].shape[0],
                                       seg[1].shape[0] * WINDOW_BITS) for seg in segments))
    return outs


# launch counters: bumped where a kernel launches and nowhere else; the
# shapes maps let a measurement time each kernel at the shapes a run used
mont_mul.launches = 0
mont_mul.shapes = {}  # (K, rows) -> launches
modmul.launches = 0
modmul.shapes = {}  # (K, rows) -> launches
modexp_segments.launches = 0
# ((K, rows, exp_bits) of each segment, in the caller's order) -> launches
modexp_segments.shapes = {}
comb.launches = 0
comb.shapes = {}  # (K, groups, rows per group, exp_bits) -> launches
comb_ladder.launches = 0
comb_ladder.shapes = {}  # (K, groups, exp_bits) -> launches
multi_modexp.launches = 0
multi_modexp.shapes = {}  # (K, rows, exp_bits_seq) -> launches
shared_exp_segments.launches = 0
# ((K, rows, exp_bits) of each segment, in the caller's order) -> launches
shared_exp_segments.shapes = {}


def launch_counts() -> dict:
    return {"cios_mont_mul": mont_mul.launches, "cios_modmul": modmul.launches,
            "cios_modexp": modexp_segments.launches, "cios_comb": comb.launches,
            "cios_comb_ladder": comb_ladder.launches,
            "cios_multi_modexp": multi_modexp.launches,
            "cios_shared_exp": shared_exp_segments.launches}


def reset_launch_counts() -> None:
    for fn in (mont_mul, modmul, modexp_segments, comb, comb_ladder, multi_modexp,
               shared_exp_segments):
        fn.launches = 0
        fn.shapes = {}
