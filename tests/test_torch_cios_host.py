"""The joint path's CUDA kernels (`fsdkr_tpu_torch/csrc/cios_kernels.cu`:
`fsdkr_cios_multi_modexp`, `fsdkr_cios_shared_exp`) and the ladder on
the same block product, compiled for the CPU and run against their
plain versions (ops.montgomery `_multi_modexp_kernel`,
`_shared_exp_kernel`, `_comb_ladder`), bit for bit.

`tests/host_cuda/cuda_host.h` and `cios_host.h` stand in for the CUDA
runtime: a block's threads are fibers on one host thread, run in turns
from one sync point (a shuffle, a ballot, a barrier) to the next, and a
launch runs its blocks one after another. The source is compiled as it
is, apart from the include, the launch syntax, the dynamic shared
memory (a function static), the sub-warp product's wide multiply (in C)
and the comb kernels' cp.async copies (cut: those kernels do not run
here). So the kernels' own code runs at the launch rule's threads a
block: one block a row on the ladder's block product `mont_mul_block`
(its column sums, normalisations and two-level lookahead), the row
body `joint_row` (the T window tables in the block's shared memory, the
general product's operand written into the split yl / yh, the masked
select of the Straus kernel, the digit-addressed entry of the
shared-exponent kernel, the active-term schedule, the exit by 1), the
one-warp form the rule takes past its rows, the ladder kernel on the
same block product, the segment table and its per-segment row counts,
the launch's argument checks, the term cap and the launch rule. What
only the card shows (the compiler's code, timing, shared-memory limits)
`chip_smoke.py` checks there.

Skipped where the host has no C++ compiler.
"""

import ctypes
import random
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels
from fsdkr_tpu_torch.ops.limbs import MontgomeryContext, ints_to_limbs, limbs_to_ints

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "fsdkr_tpu_torch" / "csrc" / "cios_kernels.cu"
SHIM = Path(__file__).resolve().parent / "host_cuda" / "cios_host.h"
_LAUNCH = re.compile(r"(\w+(?:<[^<>]*>)?)<<<([^,]+),([^,]+),[^,]+,[^>]+>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    text = SRC.read_text().replace("#include <cuda_runtime.h>", f'#include "{SHIM}"')
    # the sub-warp product's wide multiply in C; the comb's copies cut
    text, wide = re.subn(r'asm\("mul\.wide\.u32 %0, %1, %2;" : "=l"\(r\) : "r"\(a\), "r"\(b\)\);',
                         "r = (uint64_t)a * b;", text)
    assert wide == 1
    text = re.sub(r"asm volatile\(.*?\);", ";", text, flags=re.S)
    text, shared = re.subn(r"extern __shared__ __align__\(16\) uint32_t (\w+)\[\];",
                           r"static uint32_t \1[1 << 16];", text)
    assert shared == 7
    text, launches = _LAUNCH.subn(
        lambda m: f"emu_launch({m[2]}, {m[3]}, [&] {{ {m[1]}({m[4]}); }});", text)
    assert launches == 10
    out = tmp_path_factory.mktemp("cios_host")
    cpp, so = out / "cios_kernels_host.cpp", out / "libcios_kernels_host.so"
    cpp.write_text(text)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w",
                    "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fsdkr_cios_multi_modexp.argtypes = [p, p, i, ctypes.POINTER(i), i, p, p, p, p, i, i,
                                            p, p]
    lib.fsdkr_cios_multi_modexp.restype = i
    lib.fsdkr_cios_shared_exp.argtypes = [ctypes.POINTER(ctypes.c_int64), i, p]
    lib.fsdkr_cios_shared_exp.restype = i
    lib.fsdkr_cios_joint_rule.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.fsdkr_cios_comb_ladder_threads.argtypes = [i, p, p, p, p, i, i, i, p, p]
    lib.fsdkr_cios_comb_ladder_threads.restype = i
    lib.fsdkr_cios_multi_modexp_threads.argtypes = [i] + lib.fsdkr_cios_multi_modexp.argtypes
    lib.fsdkr_cios_multi_modexp_threads.restype = i
    lib.fsdkr_cios_shared_exp_threads.argtypes = [i] + lib.fsdkr_cios_shared_exp.argtypes
    lib.fsdkr_cios_shared_exp_threads.restype = i
    lib.fsdkr_cios_joint_rule.restype = i
    return lib


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int32)).contiguous()


def _moduli(rng, k, rows, worst):
    """Row 0 modulo 3, the last `worst` rows 2^(16k) - 1, the rest
    random odd k-limb moduli."""
    mods = [3] + [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1)) for _ in range(rows - 1)]
    return mods[: rows - worst] + [(1 << (16 * k)) - 1] * worst


def _multi_call(lib, bases, exps, n, ni, r2, one, widths, threads=None):
    """The launch rule's form, or `threads` (0: one warp a row)."""
    t_cnt, rows, k = bases.shape
    out = torch.zeros((rows, k), dtype=torch.int32)
    args = (bases.data_ptr(), exps.data_ptr(), exps.shape[2], (ctypes.c_int * t_cnt)(*widths),
            t_cnt, n.data_ptr(), ni.data_ptr(), r2.data_ptr(), one.data_ptr(), rows, k,
            out.data_ptr(), None)
    err = lib.fsdkr_cios_multi_modexp(*args) if threads is None else \
        lib.fsdkr_cios_multi_modexp_threads(threads, *args)
    return err, out


# (K, rows, widths), one block a row: 13 rows; 16 terms on one block;
# K=130, an odd word count; 1 row; the RLC folds' odd shapes: a 1-term row
# (the ring-Pedersen S term left over from a 257-term row cut at 16
# terms), at K=16 and at the 2048-bit K=128, and the shape of
# fold_ladder2's merged (h1, h2) row, one term three times as wide as the
# other (3072 and 1024 bits on the card). Each case's rows: modulus 3, zero
# exponents, random, and (from 4 rows) the last one worst-case
MULTI_CASES = [(16, 13, (128, 64, 64)), (16, 4, tuple(64 + 16 * (t < 8) for t in range(16))),
               (130, 4, (64, 32)), (16, 1, (64, 32)), (16, 4, (256,)), (128, 2, (256,)),
               (16, 4, (1536, 512))]


@pytest.mark.parametrize("k, rows, widths", MULTI_CASES)
def test_host_multi_modexp_matches_plain(host_lib, k, rows, widths):
    rng = random.Random(k * 100 + rows)
    worst = 1 if rows > 2 else 0
    mods = _moduli(rng, k, rows, worst)
    bases = [[rng.randrange(m) if i < rows - worst else m - 1 for i, m in enumerate(mods)]
             for _ in widths]
    exps = [[rng.getrandbits(w) if i < rows - worst else (1 << w) - 1 for i in range(rows)]
            for w in widths]
    for e in exps:
        e[min(1, rows - 1)] = 0
    ctx = MontgomeryContext(mods, k)
    args = (_t(np.stack([ints_to_limbs(b, k) for b in bases])),
            _t(np.stack([ints_to_limbs(e, widths[0] // 16) for e in exps])),
            _t(ctx.n), _t(ctx.n_inv), _t(ctx.r2), _t(ctx.one_mont))
    err, got = _multi_call(host_lib, *args, widths)
    assert err == 0
    want = montgomery._multi_modexp_kernel(*args, exp_bits_seq=widths)
    assert torch.equal(got.to(torch.int64), want)
    # the one-warp form, which the rule takes past its rows
    err, warp = _multi_call(host_lib, *args, widths, threads=0)
    assert err == 0 and torch.equal(warp, got)
    oracle = []
    for i, m in enumerate(mods):
        acc = 1 % m
        for b, e in zip(bases, exps):
            acc = acc * pow(b[i], e[i], m) % m
        oracle.append(acc)
    assert limbs_to_ints(got.numpy()) == oracle


def test_host_shared_exp_matches_plain(host_lib):
    """Three segments in one launch: K=16 modulo 3 (1 row), K=130 random
    (5 rows; the launch's widest), K=16 worst-case (6 rows); one block a
    row (the rule's), and one warp a row."""
    rng = random.Random(7)
    specs = [(16, 1, 64, 3), (130, 5, 64, None), (16, 6, 32, (1 << 256) - 1)]
    segs, oracle = [], []
    for k, rows, bits, m in specs:
        worst = m == (1 << (16 * k)) - 1
        m = m or rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))
        e = (1 << bits) - 1 if worst else rng.getrandbits(bits)
        bases = [m - 1 if worst else rng.randrange(m) for _ in range(rows)]
        ctx = MontgomeryContext([m], k)
        segs.append((_t(ints_to_limbs(bases, k)), _t(montgomery.exp_digits(e, bits)),
                     _t(ctx.n), _t(ctx.n_inv), _t(ctx.r2), _t(ctx.one_mont)))
        oracle.append([pow(b, e, m) for b in bases])
    outs = [torch.zeros_like(seg[0]) for seg in segs]
    table = (ctypes.c_int64 * (10 * len(segs)))()
    for i, (seg, out) in enumerate(zip(segs, outs)):
        table[10 * i : 10 * (i + 1)] = [*(t.data_ptr() for t in seg), out.data_ptr(),
                                        seg[0].shape[0], seg[0].shape[1], seg[1].shape[0]]
    assert host_lib.fsdkr_cios_shared_exp(table, len(segs), None) == 0
    want = montgomery_kernels.shared_exp_segments(segs)  # CPU tensors: the plain version
    for got, w, o in zip(outs, want, oracle):
        assert torch.equal(got, w)
        assert limbs_to_ints(got.numpy()) == o
    # the one-warp form, which the rule takes past its rows
    for out in outs:
        out.zero_()
    assert host_lib.fsdkr_cios_shared_exp_threads(0, table, len(segs), None) == 0
    for got, w in zip(outs, want):
        assert torch.equal(got, w)


def test_host_launch_checks_and_term_cap(host_lib):
    k, rows = 16, 2
    z = torch.zeros((rows, k), dtype=torch.int32)
    bases = torch.zeros((2, rows, k), dtype=torch.int32)
    exps = torch.zeros((2, rows, 4), dtype=torch.int32)
    # non-descending widths, a width past the exponent limbs, 17 terms
    for widths in ((32, 64), (128, 64)):
        assert _multi_call(host_lib, bases, exps, z, z, z, z, widths)[0] != 0
    many = torch.zeros((17, rows, k), dtype=torch.int32)
    assert _multi_call(host_lib, many, torch.zeros((17, rows, 4), dtype=torch.int32),
                       z, z, z, z, (64,) * 17)[0] != 0
    # the library's launch rule and term cap are the wrapper's; it refuses
    # one term past the cap (a row's tables beside the block product's
    # shared memory in 227 KB) and takes the cap, before it launches
    # anything (0 rows)
    for kk in (2, 16, 128, 130, 256, 258, 512, 1022, 1024):
        block_rows = montgomery_kernels.JOINT_BLOCK_ROWS
        for rows in (1, block_rows, block_rows + 1):
            threads, cap = ctypes.c_int(), ctypes.c_int()
            assert host_lib.fsdkr_cios_joint_rule(kk, rows, ctypes.byref(threads),
                                                  ctypes.byref(cap)) == 0
            assert (threads.value, cap.value) == (montgomery_kernels._joint_threads(kk, rows),
                                                  montgomery_kernels.multi_modexp_max_terms(kk))
    for kk in (512, 1024):
        cap = montgomery_kernels.multi_modexp_max_terms(kk)
        for t_cnt, rows in ((cap + 1, 1), (cap + 1, 0), (cap, 0)):
            zk = torch.zeros((rows, kk), dtype=torch.int32)
            err = _multi_call(host_lib, torch.zeros((t_cnt, rows, kk), dtype=torch.int32),
                              torch.zeros((t_cnt, rows, 4), dtype=torch.int32), zk, zk, zk, zk,
                              (64,) * t_cnt)[0]
            assert (err != 0) == (t_cnt > cap)


@pytest.mark.parametrize("threads", (256, 512))
def test_host_comb_ladder_matches_plain(host_lib, threads):
    """The ladder's kernel on the same block product (its general product
    and its squares' x * y column sums, both loops over the chunks): the
    16 powers base^(16^w) R mod n of 2 groups at K=16 (one modulo 3, one
    worst-case) and of 1 at K=130, against `_comb_ladder`."""
    rng = random.Random(threads)
    for k, mods in ((16, [3, (1 << 256) - 1]), (130, [rng.getrandbits(2080) | 1 | 1 << 2079])):
        bases = [m - 1 if m == (1 << 256) - 1 else rng.randrange(m) for m in mods]
        ctx = MontgomeryContext(mods, k)
        base, n, ni, r2 = (_t(a) for a in (ints_to_limbs(bases, k), ctx.n, ctx.n_inv, ctx.r2))
        w_cnt = 16
        powers = torch.zeros((w_cnt, len(mods), k), dtype=torch.int32)
        assert host_lib.fsdkr_cios_comb_ladder_threads(
            threads, base.data_ptr(), n.data_ptr(), ni.data_ptr(), r2.data_ptr(), len(mods), k,
            w_cnt, powers.data_ptr(), None) == 0
        want = montgomery._comb_ladder(base, n, ni, r2, w_cnt)
        assert torch.equal(powers.to(torch.int64), want)
