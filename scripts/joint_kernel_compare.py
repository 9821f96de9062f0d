#!/usr/bin/env python3
"""Compare forms of the joint path's kernels (csrc/cios_kernels.cu:
`fsdkr_cios_multi_modexp`, `fsdkr_cios_shared_exp`) on one NVIDIA GPU:
each given source is built, checked bit for bit against the plain
versions, and timed in turns with the others in one process.

Run from the root of a checkout, on a machine with the card:

    python3 scripts/joint_kernel_compare.py --src parent=old/cios_kernels.cu \\
        --src new=fsdkr_tpu_torch/csrc/cios_kernels.cu [--turns 2] [--out FILE.json]

Every source must keep the C interface of both entry points. The sources
are compiled at once (one nvcc each, `ops.nvcc_build`, the port's flags),
and each one's ptxas usage of the two kernels (registers, spills, stack
frame, every instantiation) is printed. A source that also exports
`fsdkr_cios_multi_modexp_threads` and `fsdkr_cios_shared_exp_threads`
is also run at each of --threads (as "NAME@256"; 0: one warp a row).

Check: the Straus kernel at the main path's three shapes (K, rows,
widths) (256, 256, (2048, 256)) (a collect's PDL joint rows), (128, 512,
(2560, 256)) and (128, 512, (3072, 768)) (distribute's), and at K=16,
130 and 1024 on 1 and 13 rows with 3 terms; the shared-exponent kernel
over the u-power's 16 segments of 16 rows at K=256 (2048-bit exponent)
and three mixed segments at K=16, 130 and 1024; chip_smoke's inputs
(half the rows worst-case, a modulus-3 row, zero exponents). Every form
must equal the plain version bit for bit. Time: each form's device time
per launch (torch.profiler, the kernel's own events, as chip_smoke's
`time` phase) at the four main-path shapes, the forms in turns: forward,
then backward, --turns times (A B B A ...), with us per product of a
row's chain. The ladder (`fsdkr_cios_comb_ladder`, on the same block
product) is checked at K=16, 130, 128 (16 groups, the main path's),
256 and 1024 and timed at the main path's (K=128, 16 groups, 2048-bit
exponent), each source at its launch rule's threads. Prints the card's
name and power limit, a line a shape, and the JSON of all times (also
written to --out).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# the main path's launches: (K, rows, widths) of the Straus kernel, and
# the shared-exponent kernel's segments (K, rows, exp_bits)
MULTI_SHAPES = [(256, 256, (2048, 256)), (128, 512, (2560, 256)), (128, 512, (3072, 768))]
SHARED_SHAPE = ((256, 16, 2048),) * 16


def load(path: Path):
    """Build one source (cached by its hash) and bind its entry points:
    (ctypes library, nvcc's ptxas report)."""
    from fsdkr_tpu_torch.ops.nvcc_build import build_library

    info = build_library(path)
    lib = ctypes.CDLL(info["so"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fsdkr_cios_multi_modexp.argtypes = [p, p, i, ctypes.POINTER(i), i, p, p, p, p, i, i,
                                            p, p]
    lib.fsdkr_cios_multi_modexp.restype = i
    lib.fsdkr_cios_shared_exp.argtypes = [ctypes.POINTER(ctypes.c_int64), i, p]
    lib.fsdkr_cios_shared_exp.restype = i
    lib.fsdkr_cios_comb_ladder.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.fsdkr_cios_comb_ladder.restype = i
    if hasattr(lib, "fsdkr_cios_multi_modexp_threads"):
        lib.fsdkr_cios_multi_modexp_threads.argtypes = [i] + lib.fsdkr_cios_multi_modexp.argtypes
        lib.fsdkr_cios_multi_modexp_threads.restype = i
        lib.fsdkr_cios_shared_exp_threads.argtypes = [i] + lib.fsdkr_cios_shared_exp.argtypes
        lib.fsdkr_cios_shared_exp_threads.restype = i
    return lib, info.get("ptxas", "")


def multi_call(lib, threads, args, widths):
    import torch

    bases, exps, n, ni, r2, one = args
    t_cnt, rows, k = bases.shape
    out = torch.empty_like(n)
    eb = (ctypes.c_int * t_cnt)(*widths)
    stream = torch.cuda.current_stream(n.device).cuda_stream
    call_args = (bases.data_ptr(), exps.data_ptr(), exps.shape[2], eb, t_cnt, n.data_ptr(),
                 ni.data_ptr(), r2.data_ptr(), one.data_ptr(), rows, k, out.data_ptr(), stream)

    def call():
        err = lib.fsdkr_cios_multi_modexp(*call_args) if threads is None else \
            lib.fsdkr_cios_multi_modexp_threads(threads, *call_args)
        if err:
            cs.fail(f"fsdkr_cios_multi_modexp: CUDA error {err}")
        return out

    return call


def shared_call(lib, threads, segs):
    import torch

    outs = [torch.empty_like(seg[0]) for seg in segs]
    table = (ctypes.c_int64 * (10 * len(segs)))()
    for i, (seg, out) in enumerate(zip(segs, outs)):
        table[10 * i : 10 * (i + 1)] = [*(t.data_ptr() for t in seg), out.data_ptr(),
                                        seg[0].shape[0], seg[0].shape[1], seg[1].shape[0]]
    stream = torch.cuda.current_stream(segs[0][0].device).cuda_stream

    def call():
        err = lib.fsdkr_cios_shared_exp(table, len(segs), stream) if threads is None else \
            lib.fsdkr_cios_shared_exp_threads(threads, table, len(segs), stream)
        if err:
            cs.fail(f"fsdkr_cios_shared_exp: CUDA error {err}")
        return outs

    return call


def ladder_call(lib, base, n, ni, r2, w_cnt):
    import torch

    out = torch.empty((w_cnt, *base.shape), dtype=torch.int32, device=base.device)
    stream = torch.cuda.current_stream(base.device).cuda_stream

    def call():
        err = lib.fsdkr_cios_comb_ladder(base.data_ptr(), n.data_ptr(), ni.data_ptr(),
                                         r2.data_ptr(), base.shape[0], base.shape[1], w_cnt,
                                         out.data_ptr(), stream)
        if err:
            cs.fail(f"fsdkr_cios_comb_ladder: CUDA error {err}")
        return out

    return call


def multi_products(widths):
    """Products along a Straus row's chain: 15 a term's table, the widest
    term's squarings, one a window of each term, the exit."""
    return 15 * len(widths) + widths[0] + sum(widths) // 4 + 1


def shared_products(exp_bits):
    return 15 + 5 * exp_bits // 4 + 1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True, help="NAME=path to a cios_kernels.cu")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--threads", default="0,256,512",
                    type=lambda v: [int(t) for t in v.split(",") if t],
                    help="layouts of a source with the _threads entries (0: one warp a row)")
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--out", default="fsdkr_tpu_torch/build/joint_compare.json")
    args = ap.parse_args()

    import random

    import torch

    from fsdkr_tpu_torch.ops import montgomery

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda", 0)
    rng = random.Random(args.seed)
    srcs = dict(s.split("=", 1) for s in args.src)
    cs.log(cs.smi_line())
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(srcs)) as pool:
        futs = {name: pool.submit(load, Path(path).resolve()) for name, path in srcs.items()}
        forms, usage = {}, {}
        for name, fut in futs.items():
            try:
                lib, report = fut.result()
            except RuntimeError as exc:  # a source that does not build drops out
                cs.log(f"{name}: build failed, left out: {exc}")
                continue
            cs.log_joint_ptxas(report, f"{name}: ")
            usage[name] = {k: cs.ptxas_entries(report, k) for k in cs.JOINT_SYMBOLS}
            forms[name] = (lib, None)
            if hasattr(lib, "fsdkr_cios_multi_modexp_threads"):
                for threads in args.threads:
                    forms[f"{name}@{threads}"] = (lib, threads)
    if not forms:
        cs.fail("no source built")
    cs.log(f"built {sorted(srcs)} in {time.perf_counter() - t0:.1f} s; forms {list(forms)}")

    # check: every form against the plain version, bit for bit
    t0 = time.perf_counter()
    multi_cases = MULTI_SHAPES + [(k, rows, (256, 192, 64)) for k in (16, 130, 1024)
                                  for rows in (1, 13)]
    for k, rows, widths in multi_cases:
        inputs = cs.multi_inputs(rng, dev, k, rows, widths, rows // 2)
        want = montgomery._multi_modexp_kernel(*inputs, exp_bits_seq=widths)
        for name, (lib, threads) in forms.items():
            if cs._max_err(multi_call(lib, threads, inputs, widths)(), want):
                cs.fail(f"{name}: cios_multi_modexp K={k} rows={rows} widths={widths} "
                        f"differs from plain")
        cs.log(f"check: cios_multi_modexp K={k} rows={rows} widths={widths}: every form == plain")
    for segments in (SHARED_SHAPE, ((16, 1, 256), (130, 13, 64), (1024, 13, 256))):
        segs = cs.shared_exp_inputs(dev, rng, segments)
        want = [montgomery._shared_exp_kernel(*seg) for seg in segs]
        for name, (lib, threads) in forms.items():
            if cs._max_err(shared_call(lib, threads, segs)(), want):
                cs.fail(f"{name}: cios_shared_exp over {sorted(set(segments))} differs from plain")
        cs.log(f"check: cios_shared_exp over {len(segments)} segments "
               f"{sorted(set(segments))}: every form == plain")
    # the ladder, on the same block product: every source at the launch
    # rule's threads (main path: K=128, 16 groups, 2048 bits)
    ladder_cases = []
    for k, groups in ((16, 3), (130, 3), (128, 16), (256, 16), (1024, 3)):
        exp_bits = 2048 if (k, groups) == (128, 16) else 64
        _, _, base, n, ni, r2, _ = cs.comb_inputs(rng, dev, k, groups, 1, exp_bits, groups // 2)
        w_cnt = exp_bits // 4
        want = montgomery._comb_ladder(base, n, ni, r2, w_cnt)
        for name in srcs:
            if name in forms and cs._max_err(ladder_call(forms[name][0], base, n, ni, r2,
                                                         w_cnt)(), want):
                cs.fail(f"{name}: cios_comb_ladder K={k} groups={groups} differs from plain")
        cs.log(f"check: cios_comb_ladder K={k} groups={groups} windows={w_cnt}: every source "
               f"== plain")
        if (k, groups) == (128, 16):
            ladder_cases = [("cios_comb_ladder", "K=128 groups=16 exp_bits=2048",
                             1 + 4 * (w_cnt - 1),
                             {n_: ladder_call(forms[n_][0], base, n, ni, r2, w_cnt)
                              for n_ in srcs if n_ in forms})]
    cs.log(f"checked in {time.perf_counter() - t0:.1f} s")

    # time in turns
    names = list(forms)
    order = []
    for turn in range(args.turns):
        order += names if turn % 2 == 0 else names[::-1]
    cases = []
    for k, rows, widths in MULTI_SHAPES:
        inputs = cs.multi_inputs(rng, dev, k, rows, widths, rows // 2)
        cases.append(("cios_multi_modexp", f"K={k} rows={rows} widths={widths}",
                      multi_products(widths),
                      {n: multi_call(lib, t, inputs, widths) for n, (lib, t) in forms.items()}))
    segs = cs.shared_exp_inputs(dev, rng, SHARED_SHAPE)
    cases.append(("cios_shared_exp", "16 segments of (K=256, 16 rows, 2048 bits)",
                  shared_products(2048),
                  {n: shared_call(lib, t, segs) for n, (lib, t) in forms.items()}))
    results = []
    for kernel, shape, chain, calls in cases + ladder_cases:
        times = {n: [] for n in names if n in calls}
        for name in order:
            if name not in calls:
                continue
            times[name].append(cs._device_ms(calls[name], cs.KERNELS[kernel][3], kernel))
        med = {n: statistics.median(v) for n, v in times.items()}
        first = next(iter(times))
        cs.log(f"time: {kernel} {shape}: " + "; ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in times[n])} ms (median {med[n]:.4f}, "
            f"{med[n] * 1e3 / chain:.3f} us a chain product, "
            f"{med[first] / med[n]:.2f}x {first})" for n in times))
        results.append({"kernel": kernel, "shape": shape, "chain_products": chain,
                        "device_ms": times, "median_ms": med})
    summary = {"device": torch.cuda.get_device_name(0), "smi": cs.smi_line(), "order": order,
               "sources": srcs, "ptxas": usage, "results": results}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    cs.log(json.dumps(summary))


if __name__ == "__main__":
    main()
