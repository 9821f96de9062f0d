#!/usr/bin/env python3
"""Compare forms of the device EC kernels (csrc/ec_kernels.cu) on one
NVIDIA GPU: each given source is built, checked bit for bit against the
plain versions, and timed in turns with the others in one process.

Run from the root of a checkout, on a machine with the card:

    python3 scripts/ec_kernel_compare.py --src parent=old/ec_kernels.cu \\
        --src new=fsdkr_tpu_torch/csrc/ec_kernels.cu [--rows 256,512,1024]
        [--trees 1x1024,16x32,16x16] [--check-rows 1,13,256,1024,4096]
        [--turns 2] [--sass] [--out FILE.json]

Every source must keep the C interface of `fsdkr_ec_scalar_mul` and
`fsdkr_ec_tree_sum`. The sources are compiled at once (one nvcc each,
`ops.nvcc_build`, so the same flags as the port's build), and each
one's ptxas usage of its two kernels (registers, spills, stack frame,
as chip_smoke's `ptxas_usage` reads it) is printed. Check:
`ec_scalar_mul` at --check-rows rows with 128- and 256-bit scalars,
`ec_tree_sum` at (1, 2), (3, 8) and the --trees shapes, on chip_smoke's inputs (edge scalars, G, the identity, a
quarter of the rows worst-case; trees of random Z with cancelling pairs,
doublings and identity pads); every source must equal the plain version
bit for bit. Time: each source's device time per launch (torch.profiler,
the kernel's own events, as chip_smoke's `time` phase) at `ec_scalar_mul`
(rows, 256-bit) for --rows and `ec_tree_sum` at the --trees shapes, the
sources in turns: forward, then backward, --turns times (A B B A ...),
and us per complete addition of a row's chain (334 for a 256-bit row, a
level a tree). --sass: each source's two kernels' static SASS, counted
by opcode (cuobjdump -sass; every inlined copy of the addition counts).
Prints the card's name and power limit, a line a shape, and the JSON
of all times (also written to --out).
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


def load(path: Path):
    """Build one source (cached by its hash) and bind its two entry points:
    (ctypes library, nvcc's ptxas report)."""
    from fsdkr_tpu_torch.ops.nvcc_build import build_library

    info = build_library(path)
    lib = ctypes.CDLL(info["so"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fsdkr_ec_scalar_mul.argtypes = [p, p, i, i, i, p, p]
    lib.fsdkr_ec_scalar_mul.restype = i
    lib.fsdkr_ec_tree_sum.argtypes = [p, i, i, p, p, p]
    lib.fsdkr_ec_tree_sum.restype = i
    return lib, info.get("ptxas", "")


def scalar_mul_call(lib, points, scalars, bits):
    import torch

    out = torch.empty_like(points)
    stream = torch.cuda.current_stream(points.device).cuda_stream

    def call():
        err = lib.fsdkr_ec_scalar_mul(points.data_ptr(), scalars.data_ptr(), points.shape[0],
                                      scalars.shape[1], bits, out.data_ptr(), stream)
        if err:
            cs.fail(f"fsdkr_ec_scalar_mul: CUDA error {err}")
        return out

    return call


def tree_sum_call(lib, points):
    import torch

    g, m = points.shape[0], points.shape[1]
    out = torch.empty((g, 3, 16), dtype=torch.int32, device=points.device)
    scratch = torch.empty((g, max(m // 2, 1), 24), dtype=torch.int32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream

    def call():
        err = lib.fsdkr_ec_tree_sum(points.data_ptr(), g, m, scratch.data_ptr(),
                                    out.data_ptr(), stream)
        if err:
            cs.fail(f"fsdkr_ec_tree_sum: CUDA error {err}")
        return out

    return call


def sass_counts(so: str) -> dict:
    """{kernel: {opcode: static count}} of the EC kernels in a library."""
    import re
    import subprocess
    from collections import Counter

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = Path(home) / "bin" / "cuobjdump"
    out = subprocess.run([str(tool) if tool.exists() else "cuobjdump", "-sass", so],
                         capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = next((k for k in ("ec_scalar_mul", "ec_tree_sum") if k in line), None)
            if name:
                counts[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            counts[name][m.group(1).split(".")[0]] += 1
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True, help="NAME=path to an ec_kernels.cu")
    ap.add_argument("--rows", default="256,512,1024")
    ap.add_argument("--trees", default="1x1024,16x32,16x16")
    ap.add_argument("--check-rows", default="1,13,256,1024,4096")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--out", default="chiprun_out/ec_compare.json")
    args = ap.parse_args()

    import random

    import torch

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
        libs, sass = {}, {}
        for name, fut in futs.items():
            try:
                libs[name], report = fut.result()
            except RuntimeError as exc:  # a source that does not build drops out
                cs.log(f"{name}: build failed, left out: {exc}")
                continue
            for kernel in ("ec_scalar_mul_kernel", "ec_tree_sum_kernel"):
                usage = cs.ptxas_usage(report, kernel)
                cs.log(f"{name}: ptxas: {kernel} "
                       + (", ".join(f"{k} {v}" for k, v in usage.items()) or "not reported"))
            if args.sass:
                sass[name] = sass_counts(libs[name]._name)
                for kernel, cnt in sass[name].items():
                    cs.log(f"{name}: sass {kernel}: {sum(cnt.values())} instructions; "
                           + ", ".join(f"{op} {n}" for op, n in cnt.most_common(16)))
    if not libs:
        cs.fail("no source built")
    cs.log(f"built {len(libs)} of {len(srcs)} sources in {time.perf_counter() - t0:.1f} s")

    from fsdkr_tpu_torch.ops import ec_batch

    # check every source against the plain versions
    t0 = time.perf_counter()
    for bits in (128, 256):
        for rows in map(int, args.check_rows.split(",")):
            points, scalars = cs.ec_inputs(rng, dev, rows, bits, rows // 4)
            want = ec_batch._scalar_mul_kernel(points, scalars, scalar_bits=bits).to(torch.int32)
            for name, lib in libs.items():
                got = scalar_mul_call(lib, points, scalars, bits)()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    cs.fail(f"{name}: ec_scalar_mul rows={rows} bits={bits} differs from plain")
            cs.log(f"check: ec_scalar_mul rows={rows} scalar_bits={bits}: every source == plain")
    trees = [tuple(map(int, t.split("x"))) for t in args.trees.split(",")]
    for groups, m in [(1, 2), (3, 8)] + trees:
        points = cs.tree_inputs(rng, dev, groups, m)
        want = ec_batch._tree_sum_kernel(points).to(torch.int32)
        for name, lib in libs.items():
            got = tree_sum_call(lib, points)()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                cs.fail(f"{name}: ec_tree_sum groups={groups} rows={m} differs from plain")
        cs.log(f"check: ec_tree_sum groups={groups} rows={m}: every source == plain")
    cs.log(f"checked in {time.perf_counter() - t0:.1f} s")

    # time in turns
    names = list(libs)
    order = []
    for turn in range(args.turns):
        order += names if turn % 2 == 0 else names[::-1]
    cases = []
    for rows in map(int, args.rows.split(",")):
        points, scalars = cs.ec_inputs(rng, dev, rows, 256, rows // 2)
        cases.append(("ec_scalar_mul", f"rows={rows} scalar_bits=256", 14 + 5 * 64,
                      {n: scalar_mul_call(lib, points, scalars, 256) for n, lib in libs.items()}))
    for groups, m in trees:
        points = cs.tree_inputs(rng, dev, groups, m)
        cases.append(("ec_tree_sum", f"groups={groups} rows={m}", max(m.bit_length() - 1, 1),
                      {n: tree_sum_call(lib, points) for n, lib in libs.items()}))
    results = []
    for kernel, shape, chain, calls in cases:
        times = {n: [] for n in names}
        for name in order:
            times[name].append(cs._device_ms(calls[name], cs.KERNELS[kernel][3], kernel))
        med = {n: statistics.median(v) for n, v in times.items()}
        first = names[0]
        cs.log(f"time: {kernel} {shape}: " + "; ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in times[n])} ms (median {med[n]:.4f}, "
            f"{med[n] * 1e3 / chain:.3f} us an addition of the chain, "
            f"{med[first] / med[n]:.2f}x {first})" for n in names))
        results.append({"kernel": kernel, "shape": shape, "chain_additions": chain,
                        "device_ms": times, "median_ms": med})
    summary = {"device": torch.cuda.get_device_name(0), "smi": cs.smi_line(), "order": order,
               "sources": srcs, "results": results,
               "sass": {n: {k: dict(c) for k, c in v.items()} for n, v in sass.items()}}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    cs.log(json.dumps(summary))


if __name__ == "__main__":
    main()
