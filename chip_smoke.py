#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fsdkr_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --phases env,kernels   # a short build-and-check

Phases:
  env      nvidia-smi name and power limit, torch/CUDA versions, the
           kernels' builds from csrc/ (the sources compiled at once, with
           nvcc's register report; `ec_scalar_mul_kernel`'s registers and
           spill bytes on a line of their own, and each instantiation's of
           the joint kernels, `cios_multi_modexp_kernel` and
           `cios_shared_exp_kernel`).
  kernels  each hand-written kernel against its plain PyTorch version on
           the card. The RNS kernels at k=131 (2048-bit class), k=260
           (4096-bit class), the 6144-bit class (k=389) and the 7168-bit
           class (k=454, where kernel 2 holds 4 rows per block), with row
           counts that do and do not fill the row tiles (kernel 1 also at
           1 and 13 rows at every class and at the main path's 4096 rows);
           the three CIOS kernels at K=16, 128, 130, 256, 512, 1022 and
           1024 limbs on 1 and 13 rows, and at K=16 and 512 on 256 rows
           (130 and 1022: an odd word count; the main path's shapes cover
           K=128 and 256 at 256 rows and more, in the `time` phase). Random
           rows (with a modulus-3 row and a zero exponent) and worst-case
           rows (every limb of x and y at n-1, every exponent bit set):
           results must be bit-identical. The segmented `cios_modexp`
           launch over mixed segments (K=128 and 256, 256- to 3072-bit
           exponents, 8-512 rows, each half random and half worst-case)
           against the plain version per segment. `cios_mont_mul` on both
           sides of the rows from which its launch rule takes the sub-warp
           kernel (R*, `rows_rule`), at K=128 and 256. `cios_comb` (the
           sub-warp kernel at the rule's lanes a row: 8, 16 and 32 all
           occur) at K=16, 128, 130, 256, 512 and 1024 on groups x rows
           per group 1 x 8, 3 x 13, 2 x 257 (ragged row tiles) and 16 x
           256 (the main path's), and `cios_comb_ladder` (one block a
           group) at K=16, 128, 130, 256, 512, 1022 and 1024 on 1, 3 and
           16 groups, at the launch rule's threads a block and at each of
           128, 256 and 512; random and worst-case groups (every limb of
           the table and the base at n-1, every exponent bit set).
           `cios_modmul` as `cios_mont_mul`, on both sides of R*.
           Device EC: `ec_scalar_mul` at 1, 13, 256, 1024 and 4096 rows
           (13: a partly filled block of 4 rows on 8 lanes each), 128-
           and 256-bit scalars (the edge scalars 0, 1, 7, N - 1 and
           2^128 - 1, G and the identity among the points, a quarter of
           the rows worst-case: every digit of N - 1 or 2^128 - 1);
           `ec_tree_sum` at (groups, rows) (1, 1),
           (1, 2), (3, 8), (16, 32) and (1, 1024) on points of random Z,
           with cancelling pairs, doublings and identity pads.
           The joint path's kernels, each case at the launch rule's
           layout and one warp a row, one block a row at 256 and 512
           threads: `cios_multi_modexp` at the
           collect's joint launch (K=256, 512 rows, widths (2048, 256)),
           the default collect's shape at 265 rows (a partial last
           wave), the distribute's two (K=128, 512 rows, (2560, 256) and
           (3072, 768)), 16 terms of 128-384 bits at K=128, and at K=16,
           130, 512 and 1024 on 1 and 13 rows with the most terms a
           block's shared memory holds (16, 16, 12, 5), half the rows
           worst-case; `multi_powm` rows of 14 terms at 8192 bits and 7
           at 16384 bits (past those caps: two launches each) against
           pow; `cios_shared_exp` over 16 segments of 16 rows at K=256
           with 2048-bit exponents (the u-power's launch), one such
           segment, and three mixed segments at K=16, 130 and 1024, the
           first modulo 3, the last worst-case.
  routes   device_powm / device_modmul (every launch through the CIOS
           engine, as routed) and the RNS route itself against CPython pow
           at 2048- and 4096-bit moduli; both entry points at 8192-bit
           moduli (past the RNS classes); device_powm_grouped (comb
           groups and loners) at 2048, 4096 and 8192 bits.
  main     on the column path (FSDKRC_MULTIEXP=0, FSDKRC_RANGEOPT=0, so
           that its gates and PERF.md's history stay comparable):
           the refresh round at paillier_bits=2048, M=256, 11 correct-key
           rounds, n=16, t=8: simulate_keygen -> distribute_batch (all 16
           senders) -> collect by all 16; t+1 new shares must interpolate
           to the group key; a collect with one tampered PDL proof must
           raise the PDL error naming the sender; the routing's kernels
           (every launch takes the CIOS engine; the ring-Pedersen
           column's 16 groups of 256 rows sharing (T, N) take the comb)
           must each launch over
           distribute + collect; launches per collect are
           printed for every kernel, and `cios_modexp` must launch twice a
           collect (once per `powm_columns` call or column: the pair
           families' columns, then correct-key's), `cios_comb` and
           `cios_comb_ladder` once each (the ring-Pedersen column); after
           the first collect, the precompute
           cache must see no miss (every modulus's constants computed
           once). Device EC: `ec_scalar_mul` launches 3 times in
           distribute (the Feldman commitments, the commit points, the
           PDL prover's u1) and 3 times a collect, `ec_tree_sum` 0 and
           3 (the Feldman, PDL u1 and pk_vec MSMs); an honest collect
           calls the per-row host u1 check no time. Then the RNS
           route's path, the earlier slices' main path cut to one
           collect (it takes device EC too): inside forced_rns_route(), both RNS
           kernels' counters zeroed just before it and read just after,
           distribute_batch by the same 16 senders (from their keys as
           they stood before the routed distribute) and one collect of
           its messages, timed layer by layer (kernel 2 must launch 15
           times, kernel 1 14); that party's collect of the same messages
           through the CIOS engine must adopt the same key.
  joint    the joint path under the defaults (FSDKRC_MULTIEXP and
           FSDKRC_RANGEOPT on), from main's keys before its distribute:
           every counter zeroed, distribute_batch by all 16 senders and
           16 collects, the counters read; the launches per distribute
           and per collect of every kernel must be JOINT_DISTRIBUTE and
           JOINT_COLLECT (PERF.md section 2), the Straus and
           shared-exponent kernels among them; t+1 new shares give the
           group key; a party's collect of the same messages on the
           column path adopts the same LocalKey; a tampered PDL row and a
           tampered range row raise what the column path raises (class,
           party, the PDL verdict tuple). Profiles one collect and times
           another layer by layer.
  time     each kernel against its plain version at every shape its path
           (the routed path for the CIOS kernels, the RNS path for the
           RNS kernels, the joint path for the Straus and shared-exponent
           kernels) launched it with (one call, rows half random, half worst-case;
           bit-identical results); each kernel timed beside its bound on
           the H100 at every one of those shapes, and at its costliest
           shape beside its plain version too. Two times per launch: `ms`,
           CUDA events around back-to-back wrapper calls (the wrapper's
           host work included where it is the slower side), and
           `device_ms`, the kernel's own device time (torch.profiler).
           A `cios_modexp` shape is its launch's segments; the launch of
           the most segments (the pair families' columns) is timed beside
           each of its segments alone, and every `cios_modexp` time is
           also given in ns per CIOS step of the launch's longest chain;
           every `cios_comb` time also in ns per row-step (a CIOS step of
           one row); every ladder time also in us per product of its
           chain, beside the chain at one SM's integer multiply rate;
           every EC time also in us per complete addition of its chain;
           every joint kernel's time also in us per product of a row's
           chain.

Prints the kernels line `{"kernels": [...]}` and, last, `{"ok": true,
"device": {...}}`. Any failure exits non-zero with no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import random
import subprocess
import sys
import time

PHASES = ("env", "kernels", "routes", "main", "joint", "time")

# H100 SXM published peaks (dense): device memory rate and int8 tensor-core
# rate. A 16x16-bit multiply-add counts as four 8-bit multiply-adds of two
# operations each: the least work an exact tensor-core route could do.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs


def rand_moduli(rng, rb, rows, bits):
    """Odd moduli of `bits` bits coprime to every channel prime."""
    import math

    prod = rb.A * rb.B * rb.m_r
    out = []
    while len(out) < rows:
        n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if math.gcd(n, prod) == 1:
            out.append(n)
    return out


def _worst_rows(rows, worst):
    """How many of `rows` rows are worst-case: all (True), none (False),
    or the given count, taken from the end."""
    return rows if worst is True else int(worst)


def kernel_inputs(rng, rb, dev, rows, exp_bits, worst):
    """Residue tensors for both RNS kernels: random rows, or worst-case
    rows (every residue m-1, every exponent bit set), or the last `worst`
    rows worst-case."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops import rns

    k = rb.k
    m = np.asarray(rb.m_all, np.int64)
    nrng = np.random.default_rng(rng.getrandbits(32))
    x = nrng.integers(0, m, size=(rows, 2 * k + 1))
    y = nrng.integers(0, m, size=(rows, 2 * k + 1))
    moduli = rand_moduli(rng, rb, rows, rb.value_bits)
    c1, nb, _a2n, _bad = rns._row_consts(rb, moduli)
    exp = nrng.integers(0, 1 << 16, size=(rows, exp_bits // 16))
    w = _worst_rows(rows, worst)
    if w:
        x[-w:] = m - 1
        y[-w:] = m - 1
        c1[-w:] = m[:k] - 1
        nb[-w:] = m[k:] - 1
        exp[-w:] = 0xFFFF

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    return t(x), t(y), t(c1), t(nb), t(exp)


def cios_inputs(rng, dev, k, rows, exp_bits, worst):
    """(x, y, n, n_inv, r2, one_mont, exp) int32 tensors for the CIOS
    kernels at K=k limbs: random rows (row 0 modulo 3, row 1 with
    exponent 0; rows take their moduli in turn from 64 random ones, as a
    column's rows repeat a party's modulus, so the host precompute stays
    small at tens of thousands of rows), or worst-case
    rows (n = 2^(16k) - 1, every limb of x and y at n - 1, every exponent
    bit set), or the last `worst` rows worst-case."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops.limbs import MontgomeryContext

    w = _worst_rows(rows, worst)
    pool = [3] + [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))
                  for _ in range(min(64, rows) - 1)] + [(1 << (16 * k)) - 1]
    pick = np.arange(rows) % (len(pool) - 1)
    pick[rows - w:] = len(pool) - 1
    ctx = MontgomeryContext(pool, k)
    n = ctx.n.astype(np.int64)[pick]
    nrng = np.random.default_rng(rng.getrandbits(32))
    # x, y below n: random limbs under a top limb below n's (and below 3
    # in the modulus-3 rows)
    xy = nrng.integers(0, 1 << 16, size=(2, rows, k))
    xy[:, :, k - 1] %= np.maximum(n[:, k - 1], 1)
    small = pick == 0
    xy[:, small] = 0
    xy[:, small, 0] = nrng.integers(0, 3, size=(2, int(small.sum())))
    xy[:, rows - w:] = n[rows - w:] - (np.arange(k) == 0)
    exp = nrng.integers(0, 1 << 16, size=(rows, exp_bits // 16))
    exp[min(1, rows - 1)] = 0
    exp[rows - w:] = 0xFFFF

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    return (t(xy[0]), t(xy[1]), t(n), t(ctx.n_inv[pick]), t(ctx.r2[pick]),
            t(ctx.one_mont[pick]), t(exp))


def cios_calls(name, args, exp_bits):
    """(kernel call, plain call) of one CIOS entry point on `args`."""
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    x, y, n, ni, r2, one, exp = args
    if name == "cios_mont_mul":
        return (lambda: mk.mont_mul(x, y, n, ni),
                lambda: montgomery.mont_mul_limbs(x, y, n, ni))
    if name == "cios_modmul":
        return (lambda: mk.modmul(x, y, n, ni, r2),
                lambda: montgomery._modmul_kernel(x, y, n, ni, r2))
    return (lambda: mk.modexp(x, exp, n, ni, r2, one, exp_bits),
            lambda: montgomery._modexp_kernel(x, exp, n, ni, r2, one, exp_bits=exp_bits))


CIOS = ("cios_mont_mul", "cios_modmul", "cios_modexp")


def modexp_segment_inputs(dev, rng, segments):
    """One `cios_modexp` segment tuple per (K, rows, exp_bits) of
    `segments`, on fresh inputs whose rows are half random, half
    worst-case."""
    segs = []
    for k, rows, exp_bits in segments:
        x, _, n, ni, r2, one, exp = cios_inputs(rng, dev, k, rows, exp_bits, rows // 2)
        segs.append((x, exp, n, ni, r2, one, exp_bits))
    return segs


def modexp_segment_calls(dev, rng, segments):
    """(kernel call, plain call) of one segmented `cios_modexp` launch over
    `segments` (`modexp_segment_inputs`): the kernel's results as a list,
    and the plain version's per segment."""
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    segs = modexp_segment_inputs(dev, rng, segments)
    return (lambda: mk.modexp_segments(segs),
            lambda: [montgomery._modexp_kernel(*seg[:6], exp_bits=seg[6]) for seg in segs])


def comb_inputs(rng, dev, k, groups, per_group, exp_bits, worst):
    """(table, exp, base, n, n_inv, r2, one_mont) int32 tensors for the
    comb's kernels at K=k limbs: random groups (group 0 modulo 3, its
    second row with exponent 0; table entries and bases below their
    modulus), or worst-case groups (n = 2^(16k) - 1, every table entry
    and the base n - 1, every exponent bit set), or the last `worst`
    groups worst-case."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops.limbs import MontgomeryContext, ints_to_limbs

    w_cnt, el = exp_bits // 4, exp_bits // 16
    nrng = np.random.default_rng(rng.getrandbits(32))
    moduli = [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1)) for _ in range(groups)]
    moduli[0] = 3
    w = _worst_rows(groups, worst)
    for g in range(groups - w, groups):
        moduli[g] = (1 << (16 * k)) - 1
    n_top = ints_to_limbs(moduli, k)[:, k - 1].astype(np.int64)
    # entries below n: random limbs under a top limb below n's
    table = nrng.integers(0, 1 << 16, size=(16, w_cnt, groups, k))
    table[..., k - 1] = nrng.integers(0, 1 << 16, size=(16, w_cnt, groups)) % np.maximum(n_top, 1)
    if groups - w > 0:  # group 0, modulo 3
        table[:, :, 0, :] = 0
        table[:, :, 0, 0] = nrng.integers(0, 3, size=(16, w_cnt))
    base = [rng.randrange(m) for m in moduli]
    exp = nrng.integers(0, 1 << 16, size=(groups, per_group, el))
    exp[0, min(1, per_group - 1)] = 0
    for g in range(groups - w, groups):
        table[:, :, g, :] = 0xFFFF
        table[:, :, g, 0] = 0xFFFE
        base[g] = moduli[g] - 1
        exp[g] = 0xFFFF
    ctx = MontgomeryContext(moduli, k)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    return (t(table), t(exp), t(ints_to_limbs(base, k)), t(ctx.n), t(ctx.n_inv), t(ctx.r2),
            t(ctx.one_mont))


def comb_calls(name, args, exp_bits):
    """(kernel call, plain call) of one comb kernel on `args`."""
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    table, exp, base, n, ni, r2, one = args
    if name == "cios_comb":
        return (lambda: mk.comb(table, exp, n, ni, one, exp_bits),
                lambda: montgomery._comb_accumulate(table, exp, n, ni, one,
                                                    exp_bits=exp_bits))
    w_cnt = exp_bits // 4
    return (lambda: mk.comb_ladder(base, n, ni, r2, w_cnt),
            lambda: montgomery._comb_ladder(base, n, ni, r2, w_cnt))


COMB = ("cios_comb", "cios_comb_ladder")

# the kernels of the joint path only (FSDKRC_MULTIEXP / FSDKRC_RANGEOPT on)
JOINT = ("cios_multi_modexp", "cios_shared_exp")
JOINT_SYMBOLS = ("cios_multi_modexp_kernel", "cios_shared_exp_kernel")


def multi_inputs(rng, dev, k, rows, widths, worst):
    """(bases (T, rows, K), exps (T, rows, EL), n, n_inv, r2, one_mont)
    int32 tensors for `cios_multi_modexp` at K=k limbs, T = len(widths)
    terms of those exponent widths (descending): random rows (row 0
    modulo 3, row 1 with every exponent 0, moduli taken in turn from 64
    random ones), the last `worst` rows worst-case (n = 2^(16k) - 1, every
    base n - 1, every exponent bit of its width set)."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops.limbs import MontgomeryContext, ints_to_limbs

    w = _worst_rows(rows, worst)
    pool = [3] + [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))
                  for _ in range(min(64, rows) - 1)]
    moduli = [pool[i % len(pool)] for i in range(rows - w)] + [(1 << (16 * k)) - 1] * w
    bases = [[rng.randrange(m) if i < rows - w else m - 1 for i, m in enumerate(moduli)]
             for _ in widths]
    exps = [[rng.getrandbits(wb) if i < rows - w else (1 << wb) - 1 for i in range(rows)]
            for wb in widths]
    if rows - w > 1:
        for e in exps:
            e[1] = 0
    ctx = MontgomeryContext(moduli, k)
    el = widths[0] // 16

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    return (t(np.stack([ints_to_limbs(b, k) for b in bases])),
            t(np.stack([ints_to_limbs(e, el) for e in exps])),
            t(ctx.n), t(ctx.n_inv), t(ctx.r2), t(ctx.one_mont))


def multi_calls(dev, rng, k, rows, widths, worst):
    """(kernel call, plain call) of one `cios_multi_modexp` launch."""
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    bases, exps, n, ni, r2, one = multi_inputs(rng, dev, k, rows, widths, worst)
    return (lambda: mk.multi_modexp(bases, exps, n, ni, r2, one, widths),
            lambda: montgomery._multi_modexp_kernel(bases, exps, n, ni, r2, one,
                                                    exp_bits_seq=widths))


def shared_exp_inputs(dev, rng, segments, worst_last=True):
    """One `cios_shared_exp` segment tuple (base, digits, n, n_inv, r2,
    one_mont) per (K, rows, exp_bits) of `segments`: a random modulus,
    bases and exponent (the first segment modulo 3), the last segment
    worst-case (n = 2^(16k) - 1, every base n - 1, every digit 15)."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops.limbs import MontgomeryContext, ints_to_limbs
    from fsdkr_tpu_torch.ops.montgomery import exp_digits

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    segs = []
    for i, (k, rows, exp_bits) in enumerate(segments):
        worst = worst_last and i == len(segments) - 1
        if worst:
            m, e = (1 << (16 * k)) - 1, (1 << exp_bits) - 1
        else:
            m = 3 if i == 0 else rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))
            e = rng.getrandbits(exp_bits)
        bases = [m - 1 if worst else rng.randrange(m) for _ in range(rows)]
        ctx = MontgomeryContext([m], k)
        segs.append((t(ints_to_limbs(bases, k)), t(exp_digits(e, exp_bits)), t(ctx.n),
                     t(ctx.n_inv), t(ctx.r2), t(ctx.one_mont)))
    return segs


def shared_exp_calls(dev, rng, segments):
    """(kernel call, plain call) of one `cios_shared_exp` launch over
    `segments`."""
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    segs = shared_exp_inputs(dev, rng, segments)
    return (lambda: mk.shared_exp_segments(segs),
            lambda: [montgomery._shared_exp_kernel(*seg) for seg in segs])

EC = ("ec_scalar_mul", "ec_tree_sum")
_EC_POOL = []  # host points the EC inputs take in turn (built once)


def ec_pool(rng):
    """62 random points, G and the identity."""
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR, N, Point, Scalar

    if not _EC_POOL:
        _EC_POOL.extend([GENERATOR * Scalar(1 + rng.randrange(N - 1)) for _ in range(62)]
                        + [GENERATOR, Point.identity()])
    return _EC_POOL


def ec_inputs(rng, dev, rows, scalar_bits, worst):
    """(points, scalars) int32 tensors for `ec_scalar_mul`: points taken in
    turn from `ec_pool` (row 1 G, row 2 the identity), scalars random
    below the group order (below 2^128 at 128 bits), rows 3-7 the edge
    scalars 0, 1, 7, the largest and 2^128 - 1; the last `worst` rows
    worst-case (the largest scalar: N - 1, or 2^128 - 1, every digit but
    the top ones 15)."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.core.secp256k1 import N
    from fsdkr_tpu_torch.ops import ec_batch

    pool = ec_pool(rng)
    pts = [pool[rng.randrange(len(pool) - 2)] for _ in range(rows)]
    pts[1:3] = pool[-2:][: max(rows - 1, 0)]
    top = N if scalar_bits == 256 else 1 << 128
    scs = [rng.randrange(top) for _ in range(rows)]
    scs[3:8] = [0, 1, 7, top - 1, (1 << 128) - 1][: max(rows - 3, 0)]
    for i in range(rows - _worst_rows(rows, worst), rows):
        scs[i] = top - 1
    limbs = ec_batch._scalars_to_limbs(scs, scalar_bits)
    return (ec_batch.points_to_device(pts, dev),
            torch.as_tensor(limbs.astype(np.int32)).to(dev).contiguous())


def tree_inputs(rng, dev, groups, m):
    """(G, M, 3, 16) int32 projective limbs for `ec_tree_sum`: `ec_pool`
    points, each scaled by a random Z (the same projective point), with
    in every group a cancelling pair (P and -P, rows 0 and M/2), a
    doubling (rows 1 and 1 + M/2) and the last eighth identity pads."""
    import torch

    from fsdkr_tpu_torch.core.secp256k1 import P, Point
    from fsdkr_tpu_torch.ops import ec_batch

    pool = ec_pool(rng)
    pts = []
    for _ in range(groups):
        grp = [pool[rng.randrange(len(pool))] for _ in range(m)]
        h = m // 2
        if m >= 2:
            grp[h] = -grp[0]
        if m >= 4:
            grp[1 + h] = grp[1]
        if m >= 8:
            grp[m - m // 8:] = [Point.identity()] * (m // 8)
        pts += grp
    proj = ec_batch.points_to_device(pts, dev).to(torch.int64)
    lam = torch.as_tensor(ec_batch.ints_to_limbs(
        [1 + rng.randrange(P - 1) for _ in pts], 16).astype("int64")).to(dev)
    scaled = torch.stack([ec_batch._fmul(proj[:, c], lam) for c in range(3)], dim=1)
    return scaled.to(torch.int32).view(groups, m, 3, 16).contiguous()


def ec_calls(name, args, scalar_bits=None):
    """(kernel call, plain call) of one EC kernel on `args`."""
    from fsdkr_tpu_torch.ops import ec_batch, ec_kernels

    if name == "ec_scalar_mul":
        points, scalars = args
        return (lambda: ec_kernels.scalar_mul(points, scalars, scalar_bits),
                lambda: ec_batch._scalar_mul_kernel(points, scalars, scalar_bits=scalar_bits))
    (points,) = args
    return (lambda: ec_kernels.tree_sum(points), lambda: ec_batch._tree_sum_kernel(points))


# ---------------------------------------------------------------------------
# phases


def phase_env(dev):
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels

    log(smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    mods = (rns_kernels, montgomery_kernels, ec_kernels)
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(mods)) as pool:
        for fut in [pool.submit(m.load_library) for m in mods]:
            fut.result()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for m in mods:
        log(f"  {m.build_info.get('so')}: {m.build_info.get('seconds', 0):.2f} s")
        for line in m.build_info.get("ptxas", "").splitlines():
            if any(w in line for w in ("registers", "Compiling entry", "smem", "spill",
                                       "stack frame")):
                log(f"  ptxas: {line.strip()}")
    usage = ptxas_usage(ec_kernels.build_info.get("ptxas", ""), "ec_scalar_mul_kernel")
    log("ptxas: ec_scalar_mul_kernel " + (", ".join(f"{k} {v}" for k, v in usage.items())
                                           or "not reported (library already built)"))
    log_joint_ptxas(montgomery_kernels.build_info.get("ptxas", ""))


def log_joint_ptxas(report, label=""):
    """The joint kernels' registers and spill bytes, one line an
    instantiation (the template argument: threads a block)."""
    for kernel in JOINT_SYMBOLS:
        entries = ptxas_entries(report, kernel)
        if not entries:
            log(f"{label}ptxas: {kernel} not reported (library already built)")
        for name, usage in entries.items():
            log(f"{label}ptxas: {kernel} {name}: "
                + ", ".join(f"{k} {v}" for k, v in usage.items()))


def ptxas_entries(report, symbol):
    """{mangled name: {registers, spill_stores, spill_loads, stack_frame}}
    of every instantiation of one kernel in nvcc's -Xptxas -v report
    (empty when the library was not built here)."""
    import re

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m[1] if symbol in m[1] else None
            if name:
                out.setdefault(name, {})
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(stack_frame=int(m[1]), spill_stores=int(m[2]),
                             spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m[1])
    return out


def ptxas_usage(report, symbol):
    """The usage of one kernel (its last instantiation) from `ptxas_entries`."""
    entries = ptxas_entries(report, symbol)
    return entries[list(entries)[-1]] if entries else {}


LADDER_THREADS = (256, 512)  # the ladder's layouts (csrc: launch_comb_ladder)


def phase_kernels(dev, rng):
    import torch

    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk, rns, rns_kernels

    # (bits, rows, kernels): 6144 bits is kernel 2's tightest shared-memory
    # budget at 8 rows per block, 7168 bits holds 4; 13 rows leave a
    # partial last tile, 1 row a tile of one; kernel 1 also at the main
    # path's 4096-row launch
    both, mont = ("mont_mul", "modexp"), ("mont_mul",)
    cases = [(2048, 64, both), (2048, 13, both), (4096, 64, both),
             (6144, 8, both), (7168, 13, both), (2048, 4096, mont),
             (2048, 1, mont), (4096, 1, mont), (4096, 13, mont),
             (6144, 1, mont), (6144, 13, mont), (7168, 1, mont)]
    for bits, rows, names in cases:
        rb = rns.rns_bases_for_bits(bits, bits // 16)
        K = rns._device_consts(rb, dev).kernel
        for worst in (False, True):
            exp_bits = 256
            x, y, c1, nb, exp = kernel_inputs(rng, rb, dev, rows, exp_bits, worst)
            got = rns_kernels.mont_mul(x, y, c1, nb, K)
            want = rns_kernels.mont_mul_plain(x, y, c1, nb, K)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                fail(f"mont_mul k={rb.k} rows={rows} worst={worst}: {bad} residues differ")
            if "modexp" in names:
                got = rns_kernels.modexp(x, exp, y, c1, nb, K, exp_bits)
                want = rns_kernels.modexp_plain(x, exp, y, c1, nb, K, exp_bits)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    fail(f"modexp k={rb.k} rows={rows} worst={worst}: {bad} residues differ")
            log(f"kernels == plain, bit-identical: {'+'.join(names)} k={rb.k} "
                f"rows={rows} exp_bits={exp_bits} worst_case={worst}")
    # the CIOS kernels: K=16 leaves lanes idle, 128 / 256 / 512 / 1024 fill
    # 2 / 4 / 8 / 16 words a lane (512: the 8192-bit route); 130 and 1022
    # leave an odd word count; the main path's shapes hold K=128 and 256
    # at 256 rows and more (`time` phase)
    exp_bits = 64
    for k in (16, 128, 130, 256, 512, 1022, 1024):
        for rows in (1, 13, 256) if k in (16, 512) else (1, 13):
            for worst in (False, True):
                args = cios_inputs(rng, dev, k, rows, exp_bits, worst)
                for name in CIOS:
                    kernel, plain = cios_calls(name, args, exp_bits)
                    if _max_err(kernel(), plain()):
                        fail(f"{name} K={k} rows={rows} worst={worst}: differs from plain")
            log(f"kernels == plain, bit-identical: {'+'.join(CIOS)} K={k} rows={rows} "
                f"exp_bits={exp_bits}, random and worst-case rows")
    # the segmented modexp: mixed K, exponent widths and row counts in one
    # launch (blocks of the longest chain first, narrow and wide bodies
    # side by side), each segment half random and half worst-case
    segments = ((128, 8, 256), (256, 13, 768), (128, 512, 3072), (256, 64, 2048),
                (128, 100, 768), (256, 512, 256))
    kernel, plain = modexp_segment_calls(dev, rng, segments)
    if _max_err(kernel(), plain()):
        fail(f"cios_modexp over segments {segments}: differs from plain")
    log(f"kernels == plain, bit-identical: cios_modexp, one launch of segments (K, rows, "
        f"exp_bits) {segments}, each half random and half worst-case")
    # cios_mont_mul and cios_modmul on both sides of R*: one warp a row
    # below (cios_modmul: 32 lanes a row), the rule's lanes a row from R*
    # (a ragged last warp just above it)
    for k in (128, 256):
        _, lanes, r_star = mk.rows_rule(k)
        for rows in (r_star - 1, r_star, r_star + 13):
            for worst in (False, 13):
                args = cios_inputs(rng, dev, k, rows, exp_bits, worst)
                for name in ("cios_mont_mul", "cios_modmul"):
                    kernel, plain = cios_calls(name, args, exp_bits)
                    if _max_err(kernel(), plain()):
                        fail(f"{name} K={k} rows={rows} worst={worst}: differs from plain")
        log(f"kernels == plain, bit-identical: cios_mont_mul+cios_modmul K={k} at "
            f"{r_star - 1}, {r_star} and {r_star + 13} rows (R*={r_star}: one warp a row "
            f"below, cios_modmul 32 lanes a row, both {lanes} lanes a row from it), random "
            f"rows and 13 worst-case")
    # cios_comb: one group (the block's rows share it), 13 and 257 rows a
    # group (ragged row tiles), and the ring-Pedersen column's 16 groups x
    # 256 rows; K=130 and 256 take 16 lanes a row, 512 and 1024 32
    for k in (16, 128, 130, 256, 512, 1024):
        for groups, per_group in ((1, 8), (3, 13), (2, 257), (16, 256)):
            for worst in (False, True):
                args = comb_inputs(rng, dev, k, groups, per_group, exp_bits, worst)
                kernel, plain = comb_calls("cios_comb", args, exp_bits)
                if _max_err(kernel(), plain()):
                    fail(f"cios_comb K={k} groups={groups} rows={per_group} "
                         f"worst={worst}: differs from plain")
            log(f"kernels == plain, bit-identical: cios_comb K={k} groups={groups} "
                f"rows per group={per_group} exp_bits={exp_bits} (at "
                f"{mk.rows_rule(k)[0]} lanes a row), random and worst-case groups")
    # the ladder, one block a group: K=16 leaves most threads idle, 130 and
    # 1022 an odd word count, 1024 several words a thread; at the rule's
    # threads a block and at every one the library builds
    for k in (16, 128, 130, 256, 512, 1022, 1024):
        for groups in (1, 3, 16):
            for worst in (False, True):
                _, _, base, n, ni, r2, _ = comb_inputs(rng, dev, k, groups, 1, exp_bits, worst)
                w_cnt = exp_bits // 4
                want = montgomery._comb_ladder(base, n, ni, r2, w_cnt)
                calls = [lambda: mk.comb_ladder(base, n, ni, r2, w_cnt)] + [
                    (lambda t: lambda: mk.comb_ladder_at_threads(t, base, n, ni, r2, w_cnt))(t)
                    for t in LADDER_THREADS]
                for call in calls:
                    if _max_err(call(), want):
                        fail(f"cios_comb_ladder K={k} groups={groups} worst={worst}: "
                             f"differs from plain")
        log(f"kernels == plain, bit-identical: cios_comb_ladder K={k} on 1, 3 and 16 groups, "
            f"exp_bits={exp_bits} (the rule's {mk.ladder_rule(k)} threads a block, and "
            f"{', '.join(map(str, LADDER_THREADS))}), random and worst-case groups")
    ec_kernels_check(dev, rng)
    joint_kernels_check(dev, rng)


# the joint kernels' layouts: one warp a row (0), one block a row at 256
# or 512 threads (csrc: fsdkr_cios_multi_modexp_threads)
JOINT_THREADS = (0, 256, 512)


def joint_kernels_check(dev, rng):
    """Both kernels of the joint path against their plain versions, bit
    for bit, at the launch rule's layout and at each of JOINT_THREADS
    (one warp a row, one block a row at 256 and 512 threads).
    `cios_multi_modexp`: the collect's joint launch under
    FSDKRC_MULTIEXP alone (K=256, 512 rows, widths (2048, 256)), the
    default collect's shape at 265 rows (more than two blocks a SM, a
    partial last wave), the distribute's two (K=128, 512 rows, (2560,
    256) and (3072, 768)), 16 terms at K=128 of 128-384 bits, and at
    K=16, 130, 512 and 1024 on 1 and 13 rows the most terms a block's
    shared memory holds there (16, 16, 12, 5); half the rows worst-case.
    Rows past those caps at 8192 and 16384 bits (14 and 7 terms) through
    `multi_powm`, split into two launches each, against pow.
    `cios_shared_exp`: the RANGEOPT u-power's launch (K=256, 16 segments
    of 16 rows, 2048-bit exponents) and one segment of it, and K=16, 130
    and 1024 on 1 and 13 rows; the first segment modulo 3, the last
    worst-case."""
    from fsdkr_tpu_torch.backend import powm
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    cases = [(256, 512, (2048, 256)), (256, 265, (2048, 256)), (128, 512, (2560, 256)),
             (128, 512, (3072, 768)),
             (128, 64, (384, 384, 320, 320, 256, 256, 256, 192, 192, 192, 128, 128, 128, 128,
                        128, 128))]
    for k in (16, 130, 512, 1024):
        t_max = mk.multi_modexp_max_terms(k)
        for rows in (1, 13):
            cases.append((k, rows, tuple(256 - 64 * (t * 3 // t_max) for t in range(t_max))))
    for k, rows, widths in cases:
        bases, exps, n, ni, r2, one = multi_inputs(rng, dev, k, rows, widths, rows // 2)
        want = montgomery._multi_modexp_kernel(bases, exps, n, ni, r2, one, exp_bits_seq=widths)
        calls = [lambda: mk.multi_modexp(bases, exps, n, ni, r2, one, widths)] + [
            (lambda t: lambda: mk.multi_modexp_at_threads(t, bases, exps, n, ni, r2, one,
                                                          widths))(t) for t in JOINT_THREADS]
        for call in calls:
            if _max_err(call(), want):
                fail(f"cios_multi_modexp K={k} rows={rows} widths={widths}: differs from plain")
        log(f"kernels == plain, bit-identical: cios_multi_modexp K={k} rows={rows} "
            f"T={len(widths)} exp_bits={widths}, {rows // 2} worst-case rows (the rule's "
            f"{mk.joint_rule(k, rows)[0]} threads a block, and "
            f"{', '.join(map(str, JOINT_THREADS))}; 0: one warp a row)")
    rows_b, rows_e, mods = [], [], []
    for bits, terms in ((8192, 14), (16384, 7)):
        m = rng.getrandbits(bits) | 1 | (1 << (bits - 1))
        for _ in range(2):
            rows_b.append(tuple(rng.randrange(m) for _ in range(terms)))
            rows_e.append(tuple(rng.getrandbits(256) for _ in range(terms)))
            mods.append(m)
    shapes_before = dict(mk.multi_modexp.shapes)
    got = powm.multi_powm(rows_b, rows_e, mods, dev)
    want = []
    for bs, es, m in zip(rows_b, rows_e, mods):
        acc = 1
        for b, e in zip(bs, es):
            acc = acc * pow(b, e, m) % m
        want.append(acc)
    if got != want:
        fail("multi_powm past the wide caps differs from pow")
    terms = sorted(len(shape[2]) for shape, count in mk.multi_modexp.shapes.items()
                   for _ in range(count - shapes_before.get(shape, 0)))
    caps = [mk.multi_modexp_max_terms(k) for k in (512, 1024)]
    if terms != sorted([14 - caps[0], caps[0], 7 - caps[1], caps[1]]):
        fail(f"multi_powm past the wide caps: Straus launches of {terms} terms, caps {caps}")
    log(f"routes == pow: multi_powm rows of 14 terms at 8192 bits and 7 at 16384 bits "
        f"(caps {caps[0]} and {caps[1]}), Straus launches of {terms} terms")
    seg_cases = [((256, 16, 2048),) * 16, ((256, 16, 2048),)]
    for k in (16, 130, 1024):
        seg_cases.append(((k, 1, 256), (k, 13, 64), (k, 13, 256)))
    for segments in seg_cases:
        segs = shared_exp_inputs(dev, rng, segments)
        want = [montgomery._shared_exp_kernel(*seg) for seg in segs]
        calls = [lambda: mk.shared_exp_segments(segs)] + [
            (lambda t: lambda: mk.shared_exp_at_threads(t, segs))(t) for t in JOINT_THREADS]
        for call in calls:
            if _max_err(call(), want):
                fail(f"cios_shared_exp over segments {segments}: differs from plain")
        log(f"kernels == plain, bit-identical: cios_shared_exp, one launch of {len(segments)} "
            f"segments (K, rows, exp_bits) {sorted(set(segments))}, the first modulo 3, "
            f"the last worst-case (the rule's threads a block, and "
            f"{', '.join(map(str, JOINT_THREADS))}; 0: one warp a row)")


def ec_kernels_check(dev, rng):
    """Both EC kernels against their plain versions, bit for bit:
    `ec_scalar_mul` at 1, 13, 256, 1024 and 4096 rows (the main path's
    launches have 256-1024; 13 leaves the last block's lane groups partly
    filled, 4096 is several blocks an SM), 128- and 256-bit scalars;
    `ec_tree_sum` from one row to the PDL u1 group's 1024."""
    for bits in (128, 256):
        for rows in (1, 13, 256, 1024, 4096):
            kernel, plain = ec_calls("ec_scalar_mul", ec_inputs(rng, dev, rows, bits, rows // 4),
                                     bits)
            if _max_err(kernel(), plain()):
                fail(f"ec_scalar_mul rows={rows} scalar_bits={bits}: differs from plain")
            log(f"kernels == plain, bit-identical: ec_scalar_mul rows={rows} scalar_bits={bits}, "
                f"edge scalars, G, the identity, {rows // 4} worst-case rows")
    for groups, m in ((1, 1), (1, 2), (3, 8), (16, 32), (1, 1024)):
        kernel, plain = ec_calls("ec_tree_sum", (tree_inputs(rng, dev, groups, m),))
        if _max_err(kernel(), plain()):
            fail(f"ec_tree_sum groups={groups} rows={m}: differs from plain")
        log(f"kernels == plain, bit-identical: ec_tree_sum groups={groups} rows={m}, random Z, "
            f"a cancelling pair, a doubling and identity pads a group")


def phase_routes(dev, rng):
    from fsdkr_tpu_torch.backend.powm import device_modmul, device_powm
    from fsdkr_tpu_torch.ops import montgomery_kernels, rns

    # CPython's pow takes most of this phase (tens of ms a row at 4096
    # bits): the row counts stay small
    for bits, rows in ((2048, 64), (4096, 32)):
        moduli = [rng.getrandbits(bits) | (1 << (bits - 1)) | 1 for _ in range(rows)]
        bases = [rng.randrange(n) for n in moduli]
        exps = [rng.getrandbits(2048) for _ in range(rows)]
        exps[0] = 0
        exps[1] = (1 << 2048) - 1
        t = [time.perf_counter()]
        want = [pow(b, e, n) for b, e, n in zip(bases, exps, moduli)]
        t.append(time.perf_counter())
        if device_powm(bases, exps, moduli, dev) != want:
            fail(f"device_powm at {bits} bits disagrees with pow")
        t.append(time.perf_counter())
        if rns.rns_modexp(bases, exps, moduli, bits, dev) != want:
            fail(f"rns_modexp at {bits} bits disagrees with pow")
        t.append(time.perf_counter())
        want = [b * e % n for b, e, n in zip(bases, exps, moduli)]
        if device_modmul(bases, exps, moduli, dev) != want:
            fail(f"device_modmul at {bits} bits disagrees with a*b % n")
        if rns.rns_modmul(bases, exps, moduli, bits, dev) != want:
            fail(f"rns_modmul at {bits} bits disagrees with a*b % n")
        t.append(time.perf_counter())
        log(f"device_powm, rns_modexp == pow; device_modmul, rns_modmul == a*b % n: "
            f"{rows} rows of {bits}-bit moduli, 2048-bit exponents (seconds: pow "
            f"{t[1] - t[0]:.3f}, device_powm {t[2] - t[1]:.3f}, rns_modexp (cold "
            f"constants) {t[3] - t[2]:.3f}, both modmuls {t[4] - t[3]:.3f})")
    # past the RNS classes: the CIOS engine at K=512
    bits, rows = 8192, 16
    moduli = [rng.getrandbits(bits) | (1 << (bits - 1)) | 1 for _ in range(rows)]
    moduli[3] = 3
    bases = [rng.randrange(n) for n in moduli]
    exps = [rng.getrandbits(256) for _ in range(rows)]
    exps[0] = 0
    before = montgomery_kernels.launch_counts()
    if device_powm(bases, exps, moduli, dev) != [
            pow(b, e, n) for b, e, n in zip(bases, exps, moduli)]:
        fail("device_powm at 8192 bits disagrees with pow")
    if device_modmul(bases, exps, moduli, dev) != [
            b * e % n for b, e, n in zip(bases, exps, moduli)]:
        fail("device_modmul at 8192 bits disagrees with a*b % n")
    after = montgomery_kernels.launch_counts()
    if after["cios_modexp"] <= before["cios_modexp"]:
        fail("device_powm at 8192 bits did not launch the CIOS modexp kernel")
    log(f"device_powm == pow, device_modmul == a*b % n: {rows} rows of 8192-bit "
        f"moduli, 256-bit exponents, through the CIOS kernels")
    grouped_routes(dev, rng)


def grouped_routes(dev, rng):
    """device_powm_grouped against pow on columns of comb groups (rows
    sharing a base and modulus) and loners: each column must launch the
    comb, its ladder kernel and the generic engine. The groups are small
    (pow checks every row), so the JAX package's rule routes them: groups
    of 4 rows, any count."""
    from fsdkr_tpu_torch.backend import powm
    from fsdkr_tpu_torch.ops import montgomery_kernels

    min_rows = 4

    # (modulus bits, groups, rows per group, exponent bits)
    for bits, groups, per_group, exp_bits in ((2048, 4, 16, 2048), (4096, 2, 12, 2048),
                                              (8192, 2, 8, 256)):
        bases, exps, moduli = [], [], []
        for g in range(groups + 2):  # two loners at the end
            n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
            b = rng.randrange(n)
            size = per_group if g < groups else min_rows - 1
            bases += [b] * size
            moduli += [n] * size
            exps += [rng.getrandbits(exp_bits) for _ in range(size)]
        exps[0] = 0
        exps[1] = (1 << exp_bits) - 1
        want = [pow(b, e, n) for b, e, n in zip(bases, exps, moduli)]
        saved = powm._SHARED_MIN_ROWS
        powm._SHARED_MIN_ROWS = min_rows
        before = montgomery_kernels.launch_counts()
        try:
            got = powm.device_powm_grouped(bases, exps, moduli, dev)
        finally:
            powm._SHARED_MIN_ROWS = saved
        after = montgomery_kernels.launch_counts()
        if got != want:
            fail(f"device_powm_grouped at {bits} bits disagrees with pow")
        launched = {k: after[k] - before[k] for k in after}
        if not all(launched[k] for k in ("cios_comb", "cios_comb_ladder", "cios_modexp")):
            fail(f"device_powm_grouped at {bits} bits launched {launched}")
        log(f"device_powm_grouped == pow: {groups} groups x {per_group} rows and "
            f"{2 * (min_rows - 1)} loners of {bits}-bit moduli, {exp_bits}-bit "
            f"exponents")


def phase_main(dev, n=16, t=8, bits=2048, m_security=256, rounds=11):
    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.core import vss
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
    from fsdkr_tpu_torch.errors import PDLwSlackProofError
    from fsdkr_tpu_torch.backend.powm import powm_cache_stats
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage, simulate_keygen

    def launch_counts():
        counts = {**montgomery_kernels.launch_counts(), **ec_kernels.launch_counts()}
        return {k: v for k, v in counts.items() if k not in JOINT}

    config = ProtocolConfig(
        paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
        backend="cuda", device=dev.type,
    )
    times = {}
    t0 = time.perf_counter()
    keys = simulate_keygen(t, n, config)
    times["keygen"] = time.perf_counter() - t0
    log(f"main: simulate_keygen t={t} n={n}: {times['keygen']:.3f} s")

    # the keys as they stand before distribute, for the RNS path and the
    # joint phase
    pre = copy.deepcopy(keys)
    pre_joint = copy.deepcopy(keys)
    for mod in (rns_kernels, montgomery_kernels, ec_kernels):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    out = RefreshMessage.distribute_batch([(k.i, k) for k in keys], n, config)
    times["distribute"] = time.perf_counter() - t0
    log(f"main: distribute_batch, {n} senders: {times['distribute']:.3f} s")
    msgs = [m for m, _ in out]
    spare = (copy.deepcopy(keys[0]), copy.deepcopy(out[0][1]))
    spare2 = (copy.deepcopy(keys[1]), copy.deepcopy(out[1][1]))
    after_distribute = launch_counts()
    # the Feldman commitments, the commit points and the PDL prover's u1:
    # one scalar-mul launch each, no MSM
    ec_distribute = {k: after_distribute[k] for k in EC}
    if ec_distribute != {"ec_scalar_mul": 3, "ec_tree_sum": 0}:
        fail(f"distribute launched the EC kernels {ec_distribute}, expected 3 and 0")

    per_collect, cache = [], []
    t0 = time.perf_counter()
    for key, (_, dk) in zip(keys, out):
        s0 = powm_cache_stats()
        c0 = time.perf_counter()
        RefreshMessage.collect(msgs, key, dk, config)
        per_collect.append(time.perf_counter() - c0)
        s1 = powm_cache_stats()
        cache.append((s1["hits"] - s0["hits"], s1["misses"] - s0["misses"]))
    times["collect_total"] = time.perf_counter() - t0
    counts = launch_counts()
    # the shapes of this window's launches, before the checks below add
    # their own
    shapes = {
        "cios_mont_mul": dict(montgomery_kernels.mont_mul.shapes),
        "cios_modmul": dict(montgomery_kernels.modmul.shapes),
        "cios_modexp": dict(montgomery_kernels.modexp_segments.shapes),
        "cios_comb": dict(montgomery_kernels.comb.shapes),
        "cios_comb_ladder": dict(montgomery_kernels.comb_ladder.shapes),
        "ec_scalar_mul": dict(ec_kernels.scalar_mul.shapes),
        "ec_tree_sum": dict(ec_kernels.tree_sum.shapes),
    }
    log(f"main: {n} collects: {times['collect_total']:.3f} s "
        f"(each {min(per_collect):.3f}..{max(per_collect):.3f} s)")
    log(f"main: launches over distribute + collect: "
        f"{counts} (RNS kernels: {rns_kernels.launch_counts()})")
    per_collect_launches = {k: (counts[k] - after_distribute[k]) / n for k in counts}
    per_collect_launches.update(
        {k: v / n for k, v in rns_kernels.launch_counts().items()})  # 0 when routed
    log("main: launches in distribute: " + json.dumps(after_distribute)
        + "; per collect: " + json.dumps(per_collect_launches))
    for name, by_shape in shapes.items():
        log(f"main: {name} launches by shape: "
            + ", ".join(f"{shape}: {c}" for shape, c in sorted(by_shape.items())))
    if not all(counts[name] > 0 for name in counts):
        fail(f"a kernel of the main path never launched: {counts}")
    # one segmented launch per powm_columns call: the pair families'
    # columns, then correct-key's column
    if per_collect_launches["cios_modexp"] != 2:
        fail(f"cios_modexp launched {per_collect_launches['cios_modexp']} times a collect, "
             f"expected 2")
    # the ring-Pedersen column's 16 groups in one comb launch, after one
    # ladder launch
    for name in ("cios_comb", "cios_comb_ladder"):
        if per_collect_launches[name] != 1:
            fail(f"{name} launched {per_collect_launches[name]} times a collect, expected 1")
    # the Feldman, PDL u1 and pk_vec MSMs: one scalar-mul and one tree-sum
    # launch each
    for name in EC:
        if per_collect_launches[name] != 3:
            fail(f"{name} launched {per_collect_launches[name]} times a collect, expected 3")
    log(f"main: precompute cache (hits, misses) per collect: {cache}; "
        f"{powm_cache_stats()}")
    if any(miss for _, miss in cache[1:]):
        fail("a warm collect missed the precompute cache")

    # t+1 new shares interpolate to the unchanged group key
    idx = list(range(t + 1))
    secret = vss.VerifiableSS(vss.ShamirSecretSharing(t, n)).reconstruct(
        idx, [keys[i].keys_linear.x_i for i in idx]
    )
    if GENERATOR * secret != keys[0].y_sum_s:
        fail("new shares do not reconstruct the group key")
    if any(k.pk_vec != keys[0].pk_vec for k in keys):
        fail("parties disagree on the new pk_vec")
    log("main: t+1 new shares reconstruct the group key; pk_vec agreed")

    # one tampered PDL proof must be blamed on its sender
    bad = copy.deepcopy(msgs)
    sender = n // 3
    p = bad[sender].pdl_proof_vec[n // 5]
    bad[sender].pdl_proof_vec[n // 5] = type(p)(
        z=p.z, u1=p.u1, u2=p.u2, u3=p.u3, s1=p.s1 + 1, s2=p.s2, s3=p.s3
    )
    t0 = time.perf_counter()
    try:
        RefreshMessage.collect(bad, spare[0], spare[1], config)
    except PDLwSlackProofError as e:
        if e.party_index != bad[sender].party_index:
            fail(f"PDL error blames party {e.party_index}, "
                 f"expected {bad[sender].party_index}")
        log(f"main: tampered collect raised {e!r}")
    else:
        fail("a tampered PDL proof passed collect")
    times["tampered_collect"] = time.perf_counter() - t0
    # the tampered collect failed before adoption, so the spare key is
    # still pre-collect: profile one honest collect on it
    if dev.type == "cuda":
        profile_collect(msgs, spare, config, sorted(per_collect)[n // 2])
    honest_u1_check(span_collect(msgs, spare2, config, "routed"), "routed")

    # the RNS route's path (the earlier slices' main path, where every
    # column took the RNS kernels), cut to one collect
    rns_counts, rns_shapes, times["rns_distribute"] = rns_path(pre, config, n)
    counts.update(rns_counts)
    shapes.update(rns_shapes)
    if any(montgomery_kernels.launch_counts()[name] for name in JOINT):
        fail(f"the column path launched a joint kernel: {montgomery_kernels.launch_counts()}")
    return counts, shapes, times, per_collect, pre_joint


# Launches of the joint path (FSDKRC_MULTIEXP and FSDKRC_RANGEOPT on, as
# by default) at n=16, 2048-bit, M=256 (PERF.md section 2). Distribute:
# `cios_modexp` for the Paillier r^n and beta^n columns, the r^e
# responses and correct-key's prover; the comb, its ladder and its table's
# four products for ring-Pedersen's prover (16 groups of 256 rows); the
# Straus kernel once a width shape of the joint commitment rows, (256,
# 2560) and (768, 3072) bits. A collect: `cios_modexp` for the PDL
# columns, the u-power's c^{-e} terms, the range z^{-e} column and
# correct-key's column; the Straus kernel for the PDL joint rows; the
# shared-exponent kernel for the 16 receiver groups' u-powers; the comb,
# its ladder and table three times (ring-Pedersen, then h1^s1 and h2^s2 of
# joint_comb2); `cios_modmul` for PDL's three products, the u-power's and
# joint_comb2's recombinations, the range's u and w, and ring-Pedersen's.
JOINT_DISTRIBUTE = {"cios_modexp": 3, "cios_multi_modexp": 2, "cios_shared_exp": 0,
                    "cios_comb": 1, "cios_comb_ladder": 1, "cios_mont_mul": 4, "cios_modmul": 0,
                    "ec_scalar_mul": 3, "ec_tree_sum": 0}
JOINT_COLLECT = {"cios_modexp": 4, "cios_multi_modexp": 1, "cios_shared_exp": 1,
                 "cios_comb": 3, "cios_comb_ladder": 3, "cios_mont_mul": 12, "cios_modmul": 8,
                 "ec_scalar_mul": 3, "ec_tree_sum": 3}


@contextlib.contextmanager
def column_path():
    """FSDKRC_MULTIEXP=0 and FSDKRC_RANGEOPT=0 inside the block: every
    prover and verifier family on the per-term column layout."""
    saved = {k: os.environ.get(k) for k in ("FSDKRC_MULTIEXP", "FSDKRC_RANGEOPT")}
    os.environ.update({k: "0" for k in saved})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _tampered_collect(msgs, spare, config, field):
    """A collect of `msgs` with one proof broken on the spare (key, dk),
    which stays pre-collect: the PDL proof of sender n/3 to receiver n/5
    (s1 + 1), or the range proof of sender n/2 to receiver n/4 (s + 1).
    Returns (the error, the tampered sender) and fails if none is raised."""
    bad = copy.deepcopy(msgs)
    n = len(msgs)
    if field == "pdl":
        sender, row = n // 3, n // 5
        p = bad[sender].pdl_proof_vec[row]
        bad[sender].pdl_proof_vec[row] = type(p)(
            z=p.z, u1=p.u1, u2=p.u2, u3=p.u3, s1=p.s1 + 1, s2=p.s2, s3=p.s3)
    else:
        sender, row = n // 2, n // 4
        p = bad[sender].range_proofs[row]
        bad[sender].range_proofs[row] = type(p)(z=p.z, e=p.e, s=p.s + 1, s1=p.s1, s2=p.s2)
    from fsdkr_tpu_torch.protocol import RefreshMessage

    try:
        RefreshMessage.collect(bad, copy.deepcopy(spare[0]), copy.deepcopy(spare[1]), config)
    except Exception as e:  # noqa: BLE001 - compared below, class and fields
        return e, bad[sender].party_index, row
    fail(f"a tampered {field} proof passed collect")


def _verdict(err):
    return (type(err).__name__, getattr(err, "party_index", None),
            tuple(getattr(err, f, None) for f in ("is_u1_eq", "is_u2_eq", "is_u3_eq")))


def phase_joint(dev, pre, n=16, t=8, bits=2048, m_security=256, rounds=11):
    """The joint path under the defaults (FSDKRC_MULTIEXP, FSDKRC_RANGEOPT
    on), from the main phase's keys before its distribute: every kernel's
    counter zeroed just before distribute_batch by all n senders and read
    after n collects. Gates: the launches per distribute and per collect
    (JOINT_DISTRIBUTE, JOINT_COLLECT); t+1 new shares give the group key;
    a party's collect of the same messages on the column path adopts the
    same key; a tampered PDL row and a tampered range row raise what the
    column path raises (class, party, the PDL verdict tuple). Profiles
    one collect and times another layer by layer. Returns (counts, shapes
    of the joint kernels, times)."""
    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.carry import to_fields
    from fsdkr_tpu_torch.core import vss
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage

    def launch_counts():
        return {**montgomery_kernels.launch_counts(), **ec_kernels.launch_counts()}

    config = ProtocolConfig(
        paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
        backend="cuda", device=dev.type,
    )
    keys = copy.deepcopy(pre)
    times = {}
    for mod in (rns_kernels, montgomery_kernels, ec_kernels):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    out = RefreshMessage.distribute_batch([(k.i, k) for k in keys], n, config)
    times["distribute"] = time.perf_counter() - t0
    msgs = [m for m, _ in out]
    after_distribute = launch_counts()
    column_key = (copy.deepcopy(keys[0]), copy.deepcopy(out[0][1]))
    # the profiled collect adopts into `spare`; the spans' collect takes
    # keys of its own
    spare = (copy.deepcopy(keys[1]), copy.deepcopy(out[1][1]))
    spare2 = (copy.deepcopy(keys[2]), copy.deepcopy(out[2][1]))
    per_collect = []
    for key, (_, dk) in zip(keys, out):
        c0 = time.perf_counter()
        RefreshMessage.collect(msgs, key, dk, config)
        per_collect.append(time.perf_counter() - c0)
    counts = launch_counts()
    shapes = {"cios_multi_modexp": dict(montgomery_kernels.multi_modexp.shapes),
              "cios_shared_exp": dict(montgomery_kernels.shared_exp_segments.shapes)}
    per = {k: (counts[k] - after_distribute[k]) / n for k in counts}
    times["collect_median"] = sorted(per_collect)[n // 2]
    log(f"joint: distribute_batch, {n} senders: {times['distribute']:.3f} s; {n} collects "
        f"{sum(per_collect):.3f} s, median {times['collect_median']:.4f} s "
        f"(each {min(per_collect):.3f}..{max(per_collect):.3f} s)")
    log("joint: launches in distribute: " + json.dumps(after_distribute)
        + "; per collect: " + json.dumps(per))
    for name, by_shape in {**shapes,
                           "cios_modexp": montgomery_kernels.modexp_segments.shapes,
                           "cios_comb": montgomery_kernels.comb.shapes,
                           "cios_comb_ladder": montgomery_kernels.comb_ladder.shapes,
                           "cios_mont_mul": montgomery_kernels.mont_mul.shapes,
                           "cios_modmul": montgomery_kernels.modmul.shapes}.items():
        log(f"joint: {name} launches by shape: "
            + ", ".join(f"{shape}: {c}" for shape, c in sorted(by_shape.items(), key=str)))
    if rns_kernels.launch_counts() != {"rns_mont_mul": 0, "rns_modexp": 0}:
        fail(f"the joint path launched the RNS kernels {rns_kernels.launch_counts()}")
    if not all(counts[name] > 0 for name in counts):
        fail(f"a kernel of the joint path never launched: {counts}")
    for want, got, where in ((JOINT_DISTRIBUTE, after_distribute, "distribute"),
                             (JOINT_COLLECT, per, "a collect")):
        diff = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if diff:
            fail(f"joint: launches in {where} (got, expected) {diff}")
    log(f"joint: launches match PERF.md section 2: distribute {JOINT_DISTRIBUTE}, "
        f"a collect {JOINT_COLLECT}")

    idx = list(range(t + 1))
    secret = vss.VerifiableSS(vss.ShamirSecretSharing(t, n)).reconstruct(
        idx, [keys[i].keys_linear.x_i for i in idx])
    if GENERATOR * secret != keys[0].y_sum_s or any(k.pk_vec != keys[0].pk_vec for k in keys):
        fail("joint: new shares do not reconstruct the group key, or pk_vec differs")
    with column_path():
        t0 = time.perf_counter()
        RefreshMessage.collect(msgs, column_key[0], column_key[1], config)
        times["column_collect"] = time.perf_counter() - t0
    if to_fields(column_key[0]) != to_fields(keys[0]):
        fail("joint: the column path's collect of the same messages adopted another key")
    log("joint: t+1 new shares reconstruct the group key; the column path's collect of the "
        f"same messages adopts the same LocalKey ({times['column_collect']:.3f} s)")
    for field in ("pdl", "range"):
        err, sender, row = _tampered_collect(msgs, spare, config, field)
        with column_path():
            col_err, _, _ = _tampered_collect(msgs, spare, config, field)
        want_cls = "PDLwSlackProofError" if field == "pdl" else "RangeProofError"
        # the PDL error names the sender; the range error, as in the
        # reference, the receiver slot
        want_party = sender if field == "pdl" else row
        if _verdict(err) != _verdict(col_err) or type(err).__name__ != want_cls or \
                err.party_index != want_party:
            fail(f"joint: tampered {field} row raised {_verdict(err)}, the column path "
                 f"{_verdict(col_err)}, expected {want_cls} naming {want_party}")
        log(f"joint: tampered {field} row raised {err!r}, as the column path does")
    if dev.type == "cuda":
        profile_collect(msgs, spare, config, times["collect_median"])
    span_collect(msgs, spare2, config, "joint")
    return counts, shapes, times


def rns_path(pre, config, n, party=2):
    """Inside forced_rns_route(), with the RNS kernels' counters zeroed
    just before and read just after: distribute_batch by all n senders
    from `pre` (their keys before the routed distribute), then `party`'s
    collect of those messages, timed layer by layer. The same party's
    collect of the same messages through the CIOS engine must adopt the
    same key. Returns the counts, the launches by shape and the
    distribute's wall time."""
    from fsdkr_tpu_torch.backend.powm import forced_rns_route, powm_cache_stats
    from fsdkr_tpu_torch.carry import to_fields
    from fsdkr_tpu_torch.ops import rns_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage

    with forced_rns_route():
        rns_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = RefreshMessage.distribute_batch([(k.i, k) for k in pre], n, config)
        wall = time.perf_counter() - t0
        msgs = [m for m, _ in out]
        routed = (copy.deepcopy(pre[party]), copy.deepcopy(out[party][1]))
        s0 = powm_cache_stats()
        totals = span_collect(msgs, (pre[party], out[party][1]), config, "rns")
        s1 = powm_cache_stats()
        counts = rns_kernels.launch_counts()
        shapes = {"rns_mont_mul": dict(rns_kernels.mont_mul.shapes),
                  "rns_modexp": dict(rns_kernels.modexp.shapes)}
    log(f"rns path: distribute_batch, {n} senders: {wall:.3f} s; then one collect; "
        f"launches {counts}; precompute cache over the collect: "
        f"{s1['hits'] - s0['hits']} hits, {s1['misses'] - s0['misses']} misses")
    for name, by_shape in shapes.items():
        log(f"rns path: {name} launches by shape: "
            + ", ".join(f"{shape}: {c}" for shape, c in sorted(by_shape.items())))
    if counts != {"rns_mont_mul": 14, "rns_modexp": 15}:
        fail(f"the RNS path launched {counts}, expected kernel 1 14 times and "
             f"kernel 2 15 times")
    honest_u1_check(totals, "rns")
    RefreshMessage.collect(msgs, routed[0], routed[1], config)
    if to_fields(pre[party]) != to_fields(routed[0]):
        fail("the RNS route's collect adopted another key than the CIOS engine's")
    log("rns path: adopted key == the same collect's through the CIOS engine")
    return counts, shapes, wall


# the layers of one collect, timed from here by wrapping the callables the
# protocol and verifier look up by name: (module path, attribute, class)
_SPANS = (
    ("fsdkr_tpu_torch.protocol.refresh", "check_structure", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "validate_feldman", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "verify_pairs", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "_pdl_u1_batch", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "_pdl_u1_host", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "batch_inv", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "verify_ring_pedersen", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.protocol.refresh", "share_recovery_check", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "verify_correct_key", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.protocol.refresh", "adopt_session", None),
    ("fsdkr_tpu_torch.protocol.refresh", "combine_committed_points", None),
    # device EC (its callers look the entry points up in ops.ec_batch);
    # the conversions host <-> device, the second of which waits for the
    # kernels
    ("fsdkr_tpu_torch.ops.ec_batch", "batch_msm", None),
    ("fsdkr_tpu_torch.ops.ec_batch", "points_to_device", None),
    ("fsdkr_tpu_torch.ops.ec_batch", "device_to_points", None),
    ("fsdkr_tpu_torch.backend.powm", "device_powm_batches", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "device_modmul", None),
    # the joint path's: the planner, the RANGEOPT engines, the host's
    # base inversions
    ("fsdkr_tpu_torch.backend.powm", "multi_powm", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "device_powm_shared_exp_groups", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "joint_comb2_groups", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "batch_base_inv", None),
    # the grouped columns' two routes: the comb and the generic engine
    # (every width batch of a powm_columns call in one launch)
    ("fsdkr_tpu_torch.backend.powm", "device_powm_shared", None),
    ("fsdkr_tpu_torch.ops.montgomery", "modexp_batches", None),
    # the RNS route's (inside forced_rns_route()); the CIOS modmul, the
    # comb (their results end in a host copy) and the batch inverse's
    # product tree
    ("fsdkr_tpu_torch.backend.powm", "device_powm", None),
    ("fsdkr_tpu_torch.ops.montgomery", "modmul", "BatchModExp"),
    ("fsdkr_tpu_torch.ops.montgomery", "shared_base_modexp", None),
    ("fsdkr_tpu_torch.ops.montgomery", "batch_mod_inv_grouped", None),
)
# the steps inside device_powm / device_modmul (ops/rns.py's globals); each
# of these spans ends in torch.cuda.synchronize(), so it holds its own
# device work. The kernel wrappers are wrapped in the `rns_kernels` name
# that ops/rns.py looks up, never in rns_kernels itself: the raw wrapper
# bumps its counter through its own global name.
_RNS_SPANS = ("_row_consts", "ints_to_limbs", "to_device", "_limbs_to_residues",
              "_crt_exit_kernel", "limbs_to_ints")
# the same for the CIOS engine's steps (ops/montgomery.py's globals)
_CIOS_SPANS = ("ints_to_limbs", "to_device", "_download_all", "_comb_table")


def span_collect(msgs, spare, config, label):
    """Wall time of each layer inside one collect (inclusive and self
    seconds, by parent span); returns the spans' totals, {(parent,
    name): [calls, inclusive s, self s]}. device_powm / device_modmul end in a host
    copy of their result, so their spans include the device time. Inside
    them, every step's span ends in a synchronize, so the device work
    falls in the step that queued it; what the columns keep as self time
    is the download of the result limbs (between `_crt_exit_kernel` and
    `limbs_to_ints`) and the Python between the steps. Which steps wait
    on the device without that synchronize: `to_device` (a copy from
    pageable host memory synchronises its stream) and `_crt_exit_kernel`
    (its carry loop reads `bool(hi.any())`)."""
    import importlib
    import types

    import torch

    from fsdkr_tpu_torch.ops import (ec_batch, ec_kernels, montgomery, montgomery_kernels, rns,
                                     rns_kernels)
    from fsdkr_tpu_torch.protocol import RefreshMessage

    stack, totals, patched = [], {}, []

    def wrap(name, fn, sync=False):
        def timed(*args, **kwargs):
            parent = stack[-1][0] if stack else "collect"
            stack.append([name, 0.0])
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                dt = time.perf_counter() - t0
                _, child = stack.pop()
                if stack:
                    stack[-1][1] += dt
                tot = totals.setdefault((parent, name), [0, 0.0, 0.0])
                tot[0] += 1
                tot[1] += dt
                tot[2] += dt - child
        return timed

    for mod_name, attr, cls_name in _SPANS:
        owner = importlib.import_module(mod_name)
        if cls_name:
            owner = getattr(owner, cls_name)
        raw = owner.__dict__[attr]
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw
        new = wrap(attr, fn)
        patched.append((owner, attr, raw))
        setattr(owner, attr, staticmethod(new) if isinstance(raw, staticmethod) else new)
    for owner, attrs in ((rns, _RNS_SPANS), (montgomery, _CIOS_SPANS)):
        for attr in attrs:
            patched.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, wrap(attr, getattr(owner, attr), sync=True))
    proxy = types.SimpleNamespace(**vars(rns_kernels))
    proxy.mont_mul = wrap("kernel 1 mont_mul", rns_kernels.mont_mul, sync=True)
    proxy.modexp = wrap("kernel 2 modexp", rns_kernels.modexp, sync=True)
    patched.append((rns, "rns_kernels", rns_kernels))
    rns.rns_kernels = proxy
    proxy = types.SimpleNamespace(**vars(montgomery_kernels))
    for attr in ("mont_mul", "modmul", "modexp_segments", "comb", "comb_ladder", "multi_modexp",
                 "shared_exp_segments"):
        setattr(proxy, attr, wrap(f"cios_{attr}", getattr(montgomery_kernels, attr),
                                  sync=True))
    patched.append((montgomery, "montgomery_kernels", montgomery_kernels))
    montgomery.montgomery_kernels = proxy
    proxy = types.SimpleNamespace(**vars(ec_kernels))
    for attr in ("scalar_mul", "tree_sum"):
        setattr(proxy, attr, wrap(f"ec_{attr}", getattr(ec_kernels, attr), sync=True))
    patched.append((ec_batch, "ec_kernels", ec_kernels))
    ec_batch.ec_kernels = proxy
    try:
        t0 = time.perf_counter()
        RefreshMessage.collect(msgs, spare[0], spare[1], config)
        wall = time.perf_counter() - t0
    finally:
        for owner, attr, raw in patched:
            setattr(owner, attr, raw)
    top = sum(tot[1] for (parent, _), tot in totals.items() if parent == "collect")
    log(f"spans ({label}): one collect {wall:.3f} s; outside the spans "
        f"{wall - top:.3f} s")
    for (parent, name), (calls, incl, own) in totals.items():
        log(f"spans ({label}):   {parent:>22} > {name:<22} calls {calls:3d}  "
            f"incl {incl:8.3f} s  self {own:8.3f} s")
    return totals


def honest_u1_check(totals, label):
    """An honest collect's PDL u1 column is one combined MSM on the card:
    `_pdl_u1_batch` once, the per-row host check never."""
    calls = {name: sum(tot[0] for (_, n), tot in totals.items() if n == name)
             for name in ("_pdl_u1_batch", "_pdl_u1_host")}
    if calls != {"_pdl_u1_batch": 1, "_pdl_u1_host": 0}:
        fail(f"an honest collect ({label}) made the u1 calls {calls}")
    log(f"spans ({label}): PDL u1 by one device MSM, no per-row host check")


def profile_collect(msgs, spare, config, median_s):
    """Device time by kernel over one collect (torch.profiler), beside
    the collect's wall time: the device's busy and idle share. The
    profiler slows the host side, so the share is given against the
    median collect without it as well."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fsdkr_tpu_torch.protocol import RefreshMessage

    t0 = time.perf_counter()
    # device activity only: recording every host-side op as well slowed
    # the profiled collect to 8.6-15.1 s
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        RefreshMessage.collect(msgs, spare[0], spare[1], config)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # device events only (kernels, memcpy, memset): a CPU op's row repeats
    # the device time of the kernels it launched
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms == 0:
        log("profile: torch.profiler saw no device time (not measured)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"profile: one collect, wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of it; "
        f"{100 * busy_ms / (median_s * 1e3):.1f}% of the median unprofiled "
        f"collect, {median_s * 1e3:.1f} ms)")
    for name, ms in top:
        log(f"profile:   {ms:10.3f} ms  {name[:90]}")
    for name, symbol in _SYMBOL.items():
        ms = sum(v for key, v in by_name.items() if symbol in key)
        log(f"profile: {name} device time in this collect: {ms:.3f} ms")


def _events_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# each kernel: a substring of its device events' (mangled) names, its
# source, the function of the JAX package it replaces, and the launches
# per timing (modexp launches take milliseconds, products microseconds)
KERNELS = {
    "rns_mont_mul": ("rns_mont_mul_kernel", "fsdkr_tpu_torch/csrc/rns_kernels.cu",
                     "fsdkr_tpu/ops/pallas_rns.py:184", 200),
    "rns_modexp": ("rns_modexp_kernel", "fsdkr_tpu_torch/csrc/rns_kernels.cu",
                   "fsdkr_tpu/ops/pallas_rns.py:317", 10),
    # both layouts: cios_mont_mul_kernel (one warp a row) and
    # cios_mont_mul_rows_kernel (from R* rows)
    "cios_mont_mul": ("cios_mont_mul_", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                      "fsdkr_tpu/ops/montgomery.py:102", 200),
    "cios_modmul": ("cios_modmul_rows_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                    "fsdkr_tpu/ops/montgomery.py:606", 200),
    "cios_modexp": ("cios_modexp_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                    "fsdkr_tpu/ops/montgomery.py:137", 10),
    "cios_comb": ("cios_comb_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                  "fsdkr_tpu/ops/montgomery.py:372", 10),
    "cios_comb_ladder": ("cios_comb_ladder_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                         "fsdkr_tpu/ops/montgomery.py:323", 10),
    "ec_scalar_mul": ("ec_scalar_mul_kernel", "fsdkr_tpu_torch/csrc/ec_kernels.cu",
                      "fsdkr_tpu/ops/ec_batch.py:136", 10),
    "ec_tree_sum": ("ec_tree_sum_kernel", "fsdkr_tpu_torch/csrc/ec_kernels.cu",
                    "fsdkr_tpu/ops/ec_batch.py:175", 50),
    "cios_multi_modexp": ("cios_multi_modexp_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                          "fsdkr_tpu/ops/montgomery.py:450", 10),
    "cios_shared_exp": ("cios_shared_exp_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                        "fsdkr_tpu/ops/montgomery.py:183", 10),
}
_SYMBOL = {name: spec[0] for name, spec in KERNELS.items()}


def _device_ms(fn, reps, name):
    """The kernel's own time per launch: the same `reps` calls as
    `_events_ms`, under torch.profiler, summing the self device time of
    the device events whose name holds the kernel's symbol, over the
    launches the profiler recorded (it may miss the first few of a
    window). The events time above also holds the wrapper's host work
    wherever that is slower than the kernel; this does not."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # one warm-up step with the profiler armed, then the recorded step; a
    # window in which the profiler recorded no launch of the kernel is
    # taken again (twice at most)
    for attempt in range(3):
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=1)
        recorded = []
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule,
                     on_trace_ready=lambda p: recorded.append(p.key_averages())) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        us, launches = 0.0, 0
        for ev in (recorded[0] if recorded else ()):
            if ev.device_type == DeviceType.CUDA and _SYMBOL[name] in ev.key:
                us += getattr(ev, "self_device_time_total", 0) or 0
                launches += ev.count
        if launches:
            break
        log(f"time: the profiler recorded no launch of {_SYMBOL[name]} "
            f"(attempt {attempt + 1}); recording again")
    if not 0 < launches <= reps or us <= 0:
        fail(f"the profiler saw {launches} launches of {_SYMBOL[name]} "
             f"({us} us) over {reps} calls")
    return us / 1e3 / launches


def _bits_of_k(k):
    from fsdkr_tpu_torch.ops import rns

    return next(b for b in (256, 512, 1024, 1536, 2048, 3072, 4096, 5120,
                            6144, 7168)
                if rns.rns_bases_for_bits(b, b // 16).k == k)


def _max_err(got, want):
    """The largest absolute difference of two tensors, or of two lists of
    tensors (a segmented launch's results)."""
    import torch

    torch.cuda.synchronize()
    if isinstance(got, list):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _shape(name, shape):
    """A shapes-map key as (k, rows, exp_bits, groups): exp_bits None for
    the products, groups None but for the comb (whose rows are groups x
    rows per group); the ladder's rows are its groups."""
    if name == "cios_comb":
        k, g, m, exp_bits = shape
        return k, g * m, exp_bits, g
    if name == "ec_scalar_mul":
        rows, bits = shape
        return 16, rows, bits, None
    if name == "ec_tree_sum":
        g, m = shape
        return 16, g * m, None, g
    return ((*shape, None) if len(shape) == 2 else shape) + (None,)


def _shape_str(name, k, rows, exp_bits, groups=None):
    if name == "ec_scalar_mul":
        return f"rows={rows} scalar_bits={exp_bits}"
    if name == "ec_tree_sum":
        return f"groups={groups} rows={rows // groups}"
    kk = "k" if name.startswith("rns") else "K"
    if name == "cios_comb":
        rows_s = f"groups={groups} rows={rows // groups}"
    else:
        rows_s = f"groups={rows}" if name == "cios_comb_ladder" else f"rows={rows}"
    return f"{kk}={k} {rows_s}" + (f" exp_bits={exp_bits}" if exp_bits else "")


def kernel_calls(name, dev, rng, k, rows, exp_bits, worst, groups=None):
    """(kernel call, plain call) on fresh inputs at one shape; `worst`
    rows (the comb's kernels: `worst` groups) worst-case."""
    if name == "ec_scalar_mul":
        return ec_calls(name, ec_inputs(rng, dev, rows, exp_bits, worst), exp_bits)
    if name == "ec_tree_sum":
        return ec_calls(name, (tree_inputs(rng, dev, groups, rows // groups),))
    if name in COMB:
        if name == "cios_comb_ladder":
            groups = rows
        args = comb_inputs(rng, dev, k, groups, rows // groups, exp_bits, worst)
        return comb_calls(name, args, exp_bits)
    if name.startswith("cios"):
        args = cios_inputs(rng, dev, k, rows, exp_bits or 64, worst)
        return cios_calls(name, args, exp_bits)
    from fsdkr_tpu_torch.ops import rns, rns_kernels

    bits = _bits_of_k(k)
    rb = rns.rns_bases_for_bits(bits, bits // 16)
    K = rns._device_consts(rb, dev).kernel
    x, y, c1, nb, exp = kernel_inputs(rng, rb, dev, rows, exp_bits or 256, worst)
    if name == "rns_mont_mul":
        return (lambda: rns_kernels.mont_mul(x, y, c1, nb, K),
                lambda: rns_kernels.mont_mul_plain(x, y, c1, nb, K))
    return (lambda: rns_kernels.modexp(x, exp, y, c1, nb, K, exp_bits),
            lambda: rns_kernels.modexp_plain(x, exp, y, c1, nb, K, exp_bits))


def _timed_ms(fn):
    """(result, CUDA-events ms) of one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# 16x16-bit multiply-adds that device EC's field arithmetic needs (a
# 32x32-bit word product is four of them, its low half three, a product by
# a constant under 2^16 two): x * y of 8 x 8 words 256; a squaring 144 (36
# word products); the reduction on p's special form 40 (a word's m = T_i
# p^{-1} mod 2^32, 3, and m * 977, 2); a product by 3 or b3 = 21 17 (a
# word's 2, and 2^256 folded back as 2^32 + 977, 1).
MUL_MACS, SQR_MACS, REDUCE_MACS, SMALL_MACS = 256, 144, 40, 17
# a complete addition: 12 products, each reduced, and 3 by small
# constants; its doubling instance takes six of the 12 as squarings
EC_ADD_MACS = 12 * (MUL_MACS + REDUCE_MACS) + 3 * SMALL_MACS
EC_DOUBLE_MACS = 6 * (SQR_MACS + MUL_MACS) + 12 * REDUCE_MACS + 3 * SMALL_MACS


def ec_chain(scalar_bits):
    """Complete additions along a scalar-mul row's chain: the table's 14,
    then 4 doublings and one add a window."""
    return 14 + 5 * scalar_bits // 4


def ec_macs(name, rows, scalar_bits, groups=None):
    """16x16-bit multiply-adds of one EC launch: per scalar-mul row the
    table's 14 additions, then per window 4 doublings and one addition;
    M - 1 additions a tree group of M rows."""
    if name == "ec_scalar_mul":
        windows = scalar_bits // 4
        return rows * ((14 + windows) * EC_ADD_MACS + 4 * windows * EC_DOUBLE_MACS)
    return (rows - groups) * EC_ADD_MACS


def bound_ms(name, k, rows, exp_bits, groups=None):
    """The least time the H100 could take for one launch: (ms, "bytes" or
    "operations"). Bytes: each input read once, each output written once
    (int32 tensors), the shared constants once. Operations: the
    multiply-adds of 16x16 bits, each four 8-bit ones: the RNS base
    extensions' 2k(k+1) per product per row, the CIOS product's 2K^2.
    The comb: W + 1 products a row (W = exp_bits / 4 windows) and the
    16-entry table of every window and group read once; its ladder: 1 +
    4(W - 1) products a group, the W powers written. Device EC: the
    multiply-adds its additions and doublings need (`ec_macs`); the points
    and scalars read once, the points written."""
    if name in EC:
        macs_per_product, products = 1, ec_macs(name, rows, exp_bits, groups)
        if name == "ec_scalar_mul":
            in_out_bytes = 4 * rows * (2 * 3 * k + exp_bits // 16)
        else:
            in_out_bytes = 4 * 3 * k * (rows + groups)
        const_bytes = 0
    elif name.startswith("rns"):
        C = 2 * k + 1
        macs_per_product = 2 * k * (k + 1)
        const_bytes = 4 * (2 * k * (k + 1) + C + (k + 1) + 2 * k)
        if name == "rns_mont_mul":
            products = rows
            in_out_bytes = 4 * rows * (3 * C + 2 * k + 1)
        else:
            products = rows * (17 + 5 * exp_bits // 4)
            in_out_bytes = 4 * rows * (3 * C + exp_bits // 16 + 2 * k + 1)
    else:
        # x, y (or base, r2, one), n, the result, and n_inv's low two limbs
        macs_per_product = 2 * k * k
        const_bytes = 0
        if name == "cios_mont_mul":
            products, limbs = rows, 4 * k + 2
        elif name == "cios_modmul":
            products, limbs = 2 * rows, 5 * k + 2
        elif name == "cios_comb":
            w_cnt = exp_bits // 4
            products = rows * (w_cnt + 1)
            # exponents and results per row; the table, n, one and n_inv's
            # low limbs per group
            limbs = exp_bits // 16 + k
            const_bytes = 4 * groups * (16 * w_cnt * k + 2 * k + 2)
        elif name == "cios_comb_ladder":
            w_cnt = exp_bits // 4
            products = rows * (1 + 4 * (w_cnt - 1))
            limbs = 3 * k + 2 + w_cnt * k  # base, r2, n, n_inv; the powers
        elif name == "cios_multi_modexp":
            # exp_bits: the terms' widths; the widest's squarings, each
            # term's window products and its 16-entry table
            widths = exp_bits
            products = rows * (widths[0] + sum(widths) // 4 + 16 * len(widths))
            # each term's base and exponent, r2, one, n, n_inv; the result
            limbs = len(widths) * (k + widths[0] // 16) + 4 * k + 2
        elif name == "cios_shared_exp":
            # one segment: each row's base and result; the modulus, its
            # constants and the digits once
            products = rows * (16 + 5 * exp_bits // 4)
            limbs = 2 * k
            const_bytes = 4 * (4 * k + 2 + exp_bits // 4)
        else:
            products = rows * (16 + 5 * exp_bits // 4)
            limbs = 5 * k + 2 + exp_bits // 16
        in_out_bytes = 4 * rows * limbs
    ops_ms = products * macs_per_product * 4 * 2 / INT8_OPS_PER_S * 1e3
    bytes_ms = (in_out_bytes + const_bytes) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _time_launch(name, fn):
    """(events ms, device ms) per launch of the kernel's wrapper."""
    reps = KERNELS[name][3]
    return _events_ms(fn, reps), _device_ms(fn, reps, name)


def modexp_bound(segments, name="cios_modexp"):
    """A segmented launch's bound (`cios_modexp`, `cios_shared_exp`): the
    sum of its segments' bounds, each as `bound_ms` gives it; bound by
    what bounds the largest."""
    parts = [bound_ms(name, k, rows, exp_bits) for k, rows, exp_bits in segments]
    return sum(ms for ms, _ in parts), max(parts)[1]


def chain_steps(shape):
    """CIOS steps (one per 32-bit word of a product) along the longest
    chain of a `cios_modexp` launch (its segments')."""
    return max((16 + 5 * exp_bits // 4) * (k // 2) for k, _, exp_bits in shape)


def ladder_products(shape):
    """Dependent products along a ladder launch's chain: the entry, then
    four squarings a window after the first."""
    _, _, exp_bits = shape
    return 1 + 4 * (exp_bits // 4 - 1)


# one SM's 32-bit integer multiply-adds a cycle (4 schedulers x 16 lanes)
SM_INT_MACS_PER_CYCLE = 64


def max_sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def ladder_chain_ms(shape, clock_hz):
    """The ladder's chain at one SM: its products, each a Montgomery
    product's 2W^2 32-bit multiply-adds at one SM's integer rate at the
    card's maximum SM clock. A yardstick for a latency-bound chain beside
    the throughput bound of `bound_ms`."""
    k = shape[0]
    macs = 2 * (k // 2) ** 2
    return ladder_products(shape) * macs / (SM_INT_MACS_PER_CYCLE * clock_hz) * 1e3


def _case(name, shape, dev, rng):
    """One main-path launch shape on fresh inputs, rows (the comb's:
    groups) half random and half worst-case: (kernel call, plain call,
    bound ms, what bounds it, the shape as text, its JSON fields)."""
    if name in ("cios_modexp", "cios_shared_exp"):
        calls = modexp_segment_calls if name == "cios_modexp" else shared_exp_calls
        kernel, plain = calls(dev, rng, shape)
        bound, by = modexp_bound(shape, name)
        text = "segments (K, rows, exp_bits) " + ", ".join(map(str, shape))
        return kernel, plain, bound, by, text, {"segments": [list(seg) for seg in shape]}
    if name == "cios_multi_modexp":
        k, rows, widths = shape
        kernel, plain = multi_calls(dev, rng, k, rows, widths, rows // 2)
        bound, by = bound_ms(name, k, rows, widths)
        return (kernel, plain, bound, by, f"K={k} rows={rows} T={len(widths)} exp_bits={widths}",
                {"k": k, "rows": rows, "exp_bits": list(widths)})
    k, rows, exp_bits, groups = _shape(name, shape)
    half = (groups or rows) // 2 if name in COMB else rows // 2
    kernel, plain = kernel_calls(name, dev, rng, k, rows, exp_bits, half, groups)
    bound, by = bound_ms(name, k, rows, exp_bits, groups)
    if name == "ec_scalar_mul":
        fields = {"rows": rows, "scalar_bits": exp_bits}
    elif name == "ec_tree_sum":
        fields = {"groups": groups, "rows": rows // groups}
    else:
        fields = {"k": k, "rows": rows, "exp_bits": exp_bits, "groups": groups}
    return (kernel, plain, bound, by, _shape_str(name, k, rows, exp_bits, groups), fields)


def comb_row_steps(shape):
    """CIOS steps of all rows of a `cios_comb` launch: W + 1 products a
    row (W = exp_bits / 4 windows) of K/2 steps."""
    k, groups, per_group, exp_bits = shape
    return groups * per_group * (exp_bits // 4 + 1) * (k // 2)


def _per_step(name, shape, dms):
    if name in EC:
        k, rows, bits, groups = _shape(name, shape)
        chain = ec_chain(bits) if name == "ec_scalar_mul" else (rows // groups).bit_length() - 1
        return f", {dms * 1e3 / max(chain, 1):.3f} us per complete addition of a row's chain ({chain})"
    if name == "cios_comb":
        return f", {dms * 1e6 / comb_row_steps(shape):.4f} ns per row-step"
    if name == "cios_comb_ladder":
        return (f", {dms * 1e3 / ladder_products(shape):.3f} us per product of the chain "
                f"(one SM's chain: {ladder_chain_ms(shape, _CLOCK['hz']):.4f} ms)")
    if name in JOINT:
        products = joint_products(name, shape)
        return f", {dms * 1e3 / products:.3f} us per product of a row's chain ({products})"
    if name != "cios_modexp":
        return ""
    return f", {dms * 1e6 / chain_steps(shape):.2f} ns per CIOS step of the longest chain"


def joint_products(name, shape):
    """Dependent products along a joint kernel's row: each term's table
    (the entry by r2 and 14 products), the widest term's squarings, one a
    window of each term, the exit (the longest segment's, for
    `cios_shared_exp`)."""
    if name == "cios_multi_modexp":
        _, _, widths = shape
        return 15 * len(widths) + widths[0] + sum(widths) // 4 + 1
    return max(16 + 5 * exp_bits // 4 for _, _, exp_bits in shape)


_CLOCK = {}  # the card's maximum SM clock, read once by phase_time


def check_and_time_shapes(dev, rng, shapes):
    """Each kernel at every shape the main path launched it with, on one
    set of inputs whose first half of rows (the comb's: groups; a
    segmented launch's: each segment's) is random and second half
    worst-case: the kernel against its plain version (bit-identical), the
    plain version's time (CUDA events, one call), the kernel's times
    (CUDA events and device time; no kernel's work depends on its data)
    and its bound. Returns the largest absolute difference of each kernel
    (0 when bit-identical), the plain times by (name, shape) and the rows
    of the per-shape table."""
    errs = {name: 0 for name in KERNELS}
    plain_ms, table = {}, []
    t0 = time.perf_counter()
    for name, by_shape in shapes.items():
        for shape, launches in sorted(by_shape.items()):
            t1 = time.perf_counter()
            kernel, plain, bound, by, shape_s, fields = _case(name, shape, dev, rng)
            want, plain_ms[name, shape] = _timed_ms(plain)
            err = _max_err(kernel(), want)
            errs[name] = max(errs[name], err)
            if err:
                fail(f"{name} disagrees with its plain version at {shape_s}")
            del want
            ms, dms = _time_launch(name, kernel)
            log(f"time: per shape {name} {shape_s}: == plain; events {ms:.4f} ms, "
                f"device {dms:.4f} ms, bound {bound:.6f} ms ({by}), device "
                f"{dms / bound:.1f}x bound, plain {plain_ms[name, shape]:.4f} ms, "
                f"{launches} launches{_per_step(name, shape, dms)} "
                f"({time.perf_counter() - t1:.1f} s)")
            table.append({"name": name, "shape": shape, "text": shape_s, "by": by,
                          "fields": fields, "launches": launches, "ms": ms, "device_ms": dms,
                          "bound_ms": bound})
    log(f"time: every kernel == plain, bit-identical, at all {len(table)} main-path "
        f"shapes, rows (the comb's: groups) half random, half worst-case; checked and "
        f"timed in {time.perf_counter() - t0:.1f} s")
    return errs, plain_ms, table


def time_segments_alone(dev, rng, segments):
    """The segmented `cios_modexp` launch over `segments` beside each of
    its segments launched alone, on the same inputs, by device time;
    returns {"joint_ms", "alone": [[K, rows, exp_bits, device ms], ...]}."""
    from fsdkr_tpu_torch.ops import montgomery_kernels as mk

    segs = modexp_segment_inputs(dev, rng, segments)
    reps = KERNELS["cios_modexp"][3]
    joint = _device_ms(lambda: mk.modexp_segments(segs), reps, "cios_modexp")
    alone = []
    for shape, seg in zip(segments, segs):
        alone.append([*shape, _device_ms(lambda: mk.modexp_segments([seg]), reps,
                                         "cios_modexp")])
        log(f"time: cios_modexp segment {shape} alone: device {alone[-1][-1]:.4f} ms"
            f"{_per_step('cios_modexp', (shape,), alone[-1][-1])}")
    longest = max(ms for *_, ms in alone)
    log(f"time: cios_modexp over the {len(segments)} segments {segments} in one launch: "
        f"device {joint:.4f} ms{_per_step('cios_modexp', segments, joint)}; the longest "
        f"segment alone {longest:.4f} ms, the segments alone one after another "
        f"{sum(ms for *_, ms in alone):.4f} ms; joint / longest alone "
        f"{joint / longest:.3f}")
    return {"joint_ms": joint, "alone": alone}


def _cost(name, shape, launches):
    if name in ("cios_modexp", "cios_shared_exp"):
        return sum(k * k * rows * exp_bits for k, rows, exp_bits in shape) * max(launches, 1)
    if name == "cios_multi_modexp":
        k, rows, widths = shape
        return k * k * rows * (widths[0] + sum(widths) // 4) * max(launches, 1)
    k, rows, exp_bits, _ = _shape(name, shape)
    return k * k * rows * (exp_bits or 1) * max(launches, 1)


def phase_time(dev, rng, counts, shapes):
    """`counts` and `shapes` are the main path's launch counts, in total
    and by kernel and shape ((k, rows), (k, rows, exp_bits), the comb's
    (k, groups, rows per group, exp_bits), or a `cios_modexp` launch's
    segments -> launches)."""
    if not all(shapes.values()):
        fail("no main-path launch shapes recorded for a kernel")
    _CLOCK["hz"] = max_sm_clock_hz()
    log(f"time: maximum SM clock {_CLOCK['hz'] / 1e6:.0f} MHz")
    errs, plain_times, per_shape = check_and_time_shapes(dev, rng, shapes)
    # the launch of the most segments: the pair families' columns
    pairs = max(shapes["cios_modexp"], key=lambda s: (len(s), _cost("cios_modexp", s, 1)))
    alone = time_segments_alone(dev, rng, pairs)
    # the kernels line: each kernel at its costliest shape on the main path
    out = []
    for name, by_shape in shapes.items():
        shape = max(by_shape, key=lambda s: _cost(name, s, by_shape[s]))
        row = next(r for r in per_shape if r["name"] == name and r["shape"] == shape)
        ms, dms, bound = row["ms"], row["device_ms"], row["bound_ms"]
        plain_ms = plain_times[name, shape]
        log(f"time: {name} at {row['text']}: events {ms:.4f} ms, device {dms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({row['by']})")
        _, source, replaces, _ = KERNELS[name]
        out.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "device_ms": dms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": row["by"],
            "library_ms": None,
            "shape": row["text"],
            "per_shape": [{**r["fields"], **{key: r[key] for key in ("launches", "ms", "device_ms",
                                                                    "bound_ms")}}
                          for r in per_shape if r["name"] == name],
            **({"segments_alone": alone} if name == "cios_modexp" else {}),
        })
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        fail(f"unknown phase in {phases}")

    import torch

    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "fsdkr_tpu_torch")):
        fail("fsdkr_tpu_torch is not beside this script: run it from a checkout")
    sys.path.insert(0, here)
    import fsdkr_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False  # no float32 on this path
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = random.Random(args.seed)
    t_start = time.perf_counter()

    counts, shapes, kernels = None, None, []

    def done(phase):
        log(f"chip_smoke: {phase} phase done at {time.perf_counter() - t_start:.1f} s")

    if "env" in phases:
        phase_env(dev)
        done("env")
    if "kernels" in phases:
        phase_kernels(dev, rng)
        done("kernels")
    if "routes" in phases:
        phase_routes(dev, rng)
        done("routes")
    pre = None
    if "main" in phases:
        with column_path():
            counts, shapes, times, per_collect, pre = phase_main(dev)
        log("main: phase seconds " + json.dumps(
            {**times, "collect_each": per_collect}))
        done("main")
    if "joint" in phases:
        if pre is None:
            fail("the joint phase takes the main phase's keys")
        jcounts, jshapes, jtimes = phase_joint(dev, pre)
        log("joint: phase seconds " + json.dumps(jtimes))
        # the joint kernels' launches are those of the joint path's run
        counts.update({name: jcounts[name] for name in JOINT})
        shapes.update(jshapes)
        done("joint")
    if "time" in phases:
        if counts is None or any(name not in shapes for name in JOINT):
            fail("the time phase needs the main and joint phases' launch counts")
        kernels = phase_time(dev, rng, counts, shapes)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
