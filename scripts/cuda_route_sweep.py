#!/usr/bin/env python3
"""Time the device routes of the PyTorch/CUDA port against each other on
one NVIDIA GPU, over the row counts and widths of the refresh's columns.
The routing constants of fsdkr_tpu_torch/backend/powm.py and
fsdkr_tpu_torch/ops/montgomery.py are read off these tables.

Run from the root of a checkout, on a machine with the card:

    python3 scripts/cuda_route_sweep.py [--cells rns,comb] [--rows 8,16,...]
                                        [--groups 1,2,...] [--reps 3]
                                        [--out FILE.json]

`rns` cells: the two arithmetic families, the RNS route (kernel 2 /
kernel 1) against the CIOS engine. For every (entry point, modulus
width, exponent width, rows): the whole
`device_powm` / `device_modmul` call, through the CIOS engine as routed
and through the RNS route inside `forced_rns_route()` (the cache warm:
one call first), timed on the host clock (median of 3 calls, each
ending in its host copy), and its device time per call under
torch.profiler: the route's kernel
(`kernel_ms`) and every device event (`busy_ms`). Rows share 16 distinct
moduli, as a refresh's columns do (one modulus per party).

`comb` cells: the fixed-base comb against the generic engine, for
columns of G groups of M rows that share a (base, modulus) pair (G = 1,
2, 4, 8, 16, 64, 256, or those of --groups; M = 4, 8, 16, 32, 64, 256;
2048- and 4096-bit moduli; 256- and 2048-bit exponents). Each cell
times the whole call two ways: `device_powm` (`generic`), and
`device_powm_grouped` with every group on the comb (`comb`; each call
must launch the comb and its ladder kernel). The precompute cache is
cleared before every call: in a refresh every party brings new
statements, so the contexts are cold in each round. Wall time on the
host clock (median of --reps calls, each ending in its host copy; one
untimed call of each way first, at the smallest cell).
_SHARED_MIN_ROWS is read off this table; the script prints, for each
floor on the rows a group, the group count from which the comb leads.

`lanes` cells: `cios_comb` at the main path's shape (K=128, 16 groups x
256 rows, 2048-bit exponents) at 8, 16 and 32 lanes a row
(`comb_at_lanes`), each launch's results equal to the others' and to
the launch rule's (`comb`): device time per launch (torch.profiler, the
kernel's own events, median of --reps windows of 3 launches; each cell's
first launch, its check, warms it) and ns per row-step. The launch rule of csrc/cios_kernels.cu (kRowsMaxWords) is read
off this table.

`mont_mul` cells: `cios_mont_mul` and `cios_modmul` at 256, 1024,
4096, 8192 and 57344 rows (or those of --mont-mul-rows), K=128 and 256,
on the sub-warp kernel at 8, 16 and 32 lanes a row (`mont_mul_at_lanes`,
`modmul_at_lanes`), `cios_mont_mul` also one warp a row, results equal:
device time per launch as above. kRowsMinRows (R*, the rows from which
the launch rule takes the rule's lanes a row; below it `cios_mont_mul`
runs one warp a row and `cios_modmul` 32 lanes) is the crossover; the
script prints each kernel's.

`ladder` cells: `cios_comb_ladder` at K=128 and 256 (or those of
--ladder-widths), 16 groups, 2048-bit exponents, at 256 and 512 threads
a block
(`comb_ladder_at_threads`), results equal to each other and to the
launch rule's: device time per launch as above, and us per product of
the chain (1 + 4(W - 1) products). The ladder's launch rule
(ladder_threads) is read off this table.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import statistics
import subprocess
import sys
import time

ROWS = [8 << i for i in range(12)]  # 8 .. 16384, the largest launch
WIDTHS = (2048, 4096)
EXP_BITS = (256, 2048)
COMB_GROUPS = (1, 2, 4, 8, 16, 64, 256)
COMB_ROWS = (4, 8, 16, 32, 64, 256)
SYMBOLS = {("powm", "rns"): "rns_modexp_kernel", ("powm", "cios"): "cios_modexp_kernel",
           ("modmul", "rns"): "rns_mont_mul_kernel", ("modmul", "cios"): "cios_modmul_rows_kernel"}


def device_times(fn, reps, symbol):
    """(route kernel ms, all device events ms) per call, torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        busy += us
        if symbol in ev.key:
            kern += us
    return kern / 1e3 / reps, busy / 1e3 / reps


COMB_WAYS = ("generic", "comb")
# the kernels each way must launch in every call, and those it must not
COMB_LAUNCHES = {
    "generic": ({"cios_modexp"}, {"cios_comb", "cios_comb_ladder"}),
    "comb": ({"cios_comb", "cios_comb_ladder"}, {"cios_modexp"}),
}


def comb_cells(dev, rng, reps, group_counts=COMB_GROUPS):
    """The comb cells (module docstring); returns their rows."""
    import torch

    from fsdkr_tpu_torch.backend import powm
    from fsdkr_tpu_torch.ops import montgomery_kernels
    from fsdkr_tpu_torch.utils.lru import clear_caches

    ways = {"generic": powm.device_powm, "comb": powm.device_powm_grouped}

    def run(way, *args):
        before = montgomery_kernels.launch_counts()
        got = ways[way](*args)
        after = montgomery_kernels.launch_counts()
        launched = {name for name in after if after[name] > before[name]}
        must, must_not = COMB_LAUNCHES[way]
        if not must <= launched or launched & must_not:
            sys.exit(f"cuda_route_sweep: the {way} way launched {sorted(launched)}")
        return got

    saved = powm._SHARED_MIN_ROWS
    table = []
    try:
        # every group on the comb
        powm._SHARED_MIN_ROWS = 1
        n = rng.getrandbits(2048) | 1 | (1 << 2047)
        for way in ways:  # builds, first launches
            run(way, [5] * 4, [rng.getrandbits(256) for _ in range(4)], [n] * 4, dev)
        for width in WIDTHS:
            for exp_bits in EXP_BITS:
                for groups in group_counts:
                    for per_group in COMB_ROWS:
                        moduli, bases = [], []
                        for _ in range(groups):
                            n = rng.getrandbits(width) | 1 | (1 << (width - 1))
                            moduli += [n] * per_group
                            bases += [rng.randrange(n)] * per_group
                        exps = [rng.getrandbits(exp_bits) for _ in bases]
                        want = None
                        row = {"width": width, "exp_bits": exp_bits, "groups": groups,
                               "rows_per_group": per_group}
                        for way in ways:
                            walls = []
                            for _ in range(reps):
                                clear_caches()
                                t0 = time.perf_counter()
                                got = run(way, bases, exps, moduli, dev)
                                walls.append(time.perf_counter() - t0)
                            if want is None:
                                want = got
                            elif got != want:
                                sys.exit(f"cuda_route_sweep: {way} disagrees with generic "
                                         f"in {row}")
                            row[f"{way}_ms"] = statistics.median(walls) * 1e3
                        table.append(row)
                        print(json.dumps(row), flush=True)
                        torch.cuda.empty_cache()
    finally:
        powm._SHARED_MIN_ROWS = saved
    return table


def comb_verdict(table):
    """What the comb cells imply: for each floor on the rows per group,
    the least group count from which the comb is ahead of the generic
    engine in every cell at or above both floors."""

    def comb_wins(r):
        return r["comb_ms"] < r["generic_ms"]

    lines = [f"comb: ahead of generic in {sum(map(comb_wins, table))} of {len(table)} cells"]
    group_counts = sorted({r["groups"] for r in table})
    for m in sorted({r["rows_per_group"] for r in table}):
        g = next((g for g in group_counts
                  if all(comb_wins(r) for r in table
                         if r["rows_per_group"] >= m and r["groups"] >= g)), None)
        lines.append(f"comb: from {m} rows a group, ahead in every cell from {g} groups up"
                     if g is not None else
                     f"comb: from {m} rows a group, behind in some cell at every group count")
    for r in table:
        lines.append("comb: {width} bits, e={exp_bits}, {groups} x {rows_per_group}: ".format(**r)
                     + ", ".join(f"{way} {r[way + '_ms']:.2f}" for way in COMB_WAYS) + " ms")
    return lines


def kernel_ms(fn, reps, symbol):
    """Median over `reps` profiler windows of 3 calls of `device_times`'
    kernel time per call (one launch a call)."""
    return statistics.median(device_times(fn, 3, symbol)[0] for _ in range(reps))


def _limbs(dev, values, k):
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops.limbs import ints_to_limbs

    return torch.as_tensor(np.asarray(ints_to_limbs(values, k), np.int32)).to(dev).contiguous()


LANES = (8, 16, 32)


def built(k, lanes):
    """Whether the library has a sub-warp kernel at K limbs and `lanes`
    lanes a row: P (a power of two with lanes * P >= K/2) at most 8, or
    16 at 32 lanes (csrc/cios_kernels.cu FSDKR_ROWS_DISPATCH)."""
    p = 1
    while lanes * p < k // 2:
        p *= 2
    return p <= 8 or (lanes, p) == (32, 16)


def lanes_cells(dev, rng, reps, k=128, groups=16, per_group=256, exp_bits=2048):
    """The comb at each lanes a row, at the main path's shape."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops import montgomery_kernels as mk
    from fsdkr_tpu_torch.ops.limbs import MontgomeryContext

    moduli = [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1)) for _ in range(groups)]
    ctx = MontgomeryContext(moduli, k)
    w_cnt = exp_bits // 4
    entries = [rng.randrange(n) for _ in range(16 * w_cnt) for n in moduli]
    table = _limbs(dev, entries, k).reshape(16, w_cnt, groups, k)
    nrng = np.random.default_rng(rng.getrandbits(32))
    exp = torch.as_tensor(nrng.integers(0, 1 << 16, size=(groups, per_group, exp_bits // 16),
                                        dtype=np.int32)).to(dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    n, ni, one = t(ctx.n), t(ctx.n_inv), t(ctx.one_mont)
    want = mk.comb(table, exp, n, ni, one, exp_bits)
    rule = mk.rows_rule(k)[0]
    row_steps = groups * per_group * (w_cnt + 1) * (k // 2)
    table_rows = []
    for lanes in LANES:
        def call():
            return mk.comb_at_lanes(lanes, table, exp, n, ni, one, exp_bits)

        if not torch.equal(call(), want):
            sys.exit(f"cuda_route_sweep: comb at {lanes} lanes a row differs from the rule's")
        ms = kernel_ms(call, reps, "cios_comb_kernel")
        row = {"cell": "lanes", "k": k, "groups": groups, "rows_per_group": per_group,
               "exp_bits": exp_bits, "lanes": lanes, "rule": lanes == rule,
               "device_ms": ms, "ns_per_row_step": ms * 1e6 / row_steps}
        table_rows.append(row)
        print(json.dumps(row), flush=True)
    best = min(table_rows, key=lambda r: r["device_ms"])
    print(f"lanes: fastest at {best['lanes']} lanes a row ({best['device_ms']:.4f} ms); "
          f"the launch rule takes {rule} at K={k}", flush=True)
    return table_rows


# wrapper name -> (its layout below R*: 0 for one warp a row, else lanes
# a row; profiler symbol one warp a row, sub-warp)
MONT_MUL_KERNELS = {
    "mont_mul": (0, "cios_mont_mul_kernel", "cios_mont_mul_rows_kernel"),
    "modmul": (32, None, "cios_modmul_rows_kernel"),
}


MONT_MUL_ROWS = (256, 1024, 4096, 8192, 57344)


def mont_mul_cells(dev, rng, reps, widths=(128, 256), row_counts=MONT_MUL_ROWS):
    """`cios_mont_mul` and `cios_modmul` at each layout."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops import montgomery_kernels as mk
    from fsdkr_tpu_torch.ops.limbs import MontgomeryContext

    table_rows = []
    for k in widths:
        pool = [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1)) for _ in range(64)]
        _, rule_lanes, min_rows = mk.rows_rule(k)
        for rows in row_counts:
            moduli = [pool[i % 64] for i in range(rows)]
            ctx = MontgomeryContext(moduli, k)
            n, ni, r2 = (torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()
                         for a in (ctx.n, ctx.n_inv, ctx.r2))
            x = _limbs(dev, [rng.randrange(m) for m in moduli], k)
            y = _limbs(dev, [rng.randrange(m) for m in moduli], k)
            calls = {
                "mont_mul": (lambda: mk.mont_mul(x, y, n, ni),
                             lambda lanes: mk.mont_mul_at_lanes(lanes, x, y, n, ni)),
                "modmul": (lambda: mk.modmul(x, y, n, ni, r2),
                           lambda lanes: mk.modmul_at_lanes(lanes, x, y, n, ni, r2)),
            }
            for kernel, (by_rule, at_lanes) in calls.items():
                below, one_warp, sub_warp = MONT_MUL_KERNELS[kernel]
                want = at_lanes(32)
                if not torch.equal(by_rule(), want):
                    sys.exit(f"cuda_route_sweep: {kernel} by the rule differs at K={k} "
                             f"rows={rows}")
                row = {"cell": "mont_mul", "kernel": kernel, "k": k, "rows": rows,
                       "rule_lanes": rule_lanes, "rule_min_rows": min_rows,
                       "below_min_rows": below}
                layouts = (0,) if one_warp else ()
                for lanes in layouts + tuple(L for L in LANES if built(k, L)):
                    def call():
                        return at_lanes(lanes)

                    if not torch.equal(call(), want):
                        sys.exit(f"cuda_route_sweep: {kernel} at {lanes} lanes differs at "
                                 f"K={k} rows={rows}")
                    row[f"lanes_{lanes}_ms"] = kernel_ms(call, reps,
                                                         sub_warp if lanes else one_warp)
                table_rows.append(row)
                print(json.dumps(row), flush=True)
    for kernel in MONT_MUL_KERNELS:
        for k in widths:
            cells = [r for r in table_rows if r["k"] == k and r["kernel"] == kernel]
            lanes, below = cells[0]["rule_lanes"], cells[0]["below_min_rows"]
            under = f"{below} lanes a row" if below else "one warp a row"
            ahead = [r["rows"] for r in cells
                     if r[f"lanes_{lanes}_ms"] <= r[f"lanes_{below}_ms"]]
            star = next((r["rows"] for r in cells
                         if all(c["rows"] in ahead for c in cells if c["rows"] >= r["rows"])),
                        None)
            print(f"{kernel}: K={k}, the sub-warp kernel at {lanes} lanes a row "
                  + (f"at or ahead of {under} from {star} rows up" if star else
                     f"behind {under} at the largest launch")
                  + f"; the launch rule's R* is {cells[0]['rule_min_rows']}", flush=True)
    return table_rows


LADDER_THREADS = (256, 512)
LADDER_WIDTHS = (128, 256)


def ladder_cells(dev, rng, reps, widths=LADDER_WIDTHS, groups=16, exp_bits=2048):
    """The ladder at each threads a block, at the main path's group count
    and exponent width."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops import montgomery_kernels as mk
    from fsdkr_tpu_torch.ops.limbs import MontgomeryContext

    w_cnt = exp_bits // 4
    products = 1 + 4 * (w_cnt - 1)
    table_rows = []
    for k in widths:
        moduli = [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1)) for _ in range(groups)]
        ctx = MontgomeryContext(moduli, k)
        n, ni, r2 = (torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()
                     for a in (ctx.n, ctx.n_inv, ctx.r2))
        base = _limbs(dev, [rng.randrange(m) for m in moduli], k)
        want = mk.comb_ladder(base, n, ni, r2, w_cnt)
        rule = mk.ladder_rule(k)
        for threads in LADDER_THREADS:
            def call():
                return mk.comb_ladder_at_threads(threads, base, n, ni, r2, w_cnt)

            if not torch.equal(call(), want):
                sys.exit(f"cuda_route_sweep: the ladder at {threads} threads differs from the "
                         f"rule's at K={k}")
            ms = kernel_ms(call, reps, "cios_comb_ladder_kernel")
            row = {"cell": "ladder", "k": k, "groups": groups, "exp_bits": exp_bits,
                   "threads": threads, "rule": threads == rule, "device_ms": ms,
                   "us_per_product": ms * 1e3 / products}
            table_rows.append(row)
            print(json.dumps(row), flush=True)
        best = min((r for r in table_rows if r["k"] == k), key=lambda r: r["device_ms"])
        print(f"ladder: K={k}, fastest at {best['threads']} threads a block "
              f"({best['device_ms']:.4f} ms); the launch rule takes {rule}", flush=True)
    return table_rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the table to this JSON file")
    ap.add_argument("--seed", type=int, default=6)
    ap.add_argument("--cells", default="rns,comb,lanes,mont_mul,ladder",
                    help="comma-separated subset of rns,comb,lanes,mont_mul,ladder "
                         "(default: all)")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)),
                    help="comma-separated row counts of the rns cells (default: 8 .. 16384)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed calls per comb cell and way, profiler windows per lanes "
                         "mont_mul and ladder cell (default 3)")
    ap.add_argument("--mont-mul-rows", default=",".join(map(str, MONT_MUL_ROWS)),
                    help="comma-separated row counts of the mont_mul cells "
                         "(default: 256, 1024, 4096, 8192, 57344)")
    ap.add_argument("--ladder-widths", default=",".join(map(str, LADDER_WIDTHS)),
                    help="comma-separated limb counts K of the ladder cells (default: 128, 256)")
    ap.add_argument("--groups", default=",".join(map(str, COMB_GROUPS)),
                    help="comma-separated group counts of the comb cells "
                         "(default: 1, 2, 4, 8, 16, 64, 256)")
    args = ap.parse_args()
    row_counts = [int(r) for r in args.rows.split(",") if r]
    cells = [c for c in args.cells.split(",") if c]
    if any(c not in ("rns", "comb", "lanes", "mont_mul", "ladder") for c in cells):
        sys.exit(f"cuda_route_sweep: unknown cells in {cells}")

    import torch

    if not torch.cuda.is_available():
        sys.exit("cuda_route_sweep: torch finds no CUDA device")
    sys.path.insert(0, os.getcwd())
    from fsdkr_tpu_torch.backend import powm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    rng = random.Random(args.seed)
    table = []
    for width in WIDTHS if "rns" in cells else ():
        distinct = [rng.getrandbits(width) | 1 | (1 << (width - 1)) for _ in range(16)]
        for rows in row_counts:
            moduli = [distinct[i % 16] for i in range(rows)]
            bases = [rng.randrange(m) for m in moduli]
            cases = [("modmul", None, [rng.randrange(m) for m in moduli])]
            cases += [("powm", e, [rng.getrandbits(e) for _ in range(rows)]) for e in EXP_BITS]
            for entry, exp_bits, other in cases:
                fn = powm.device_powm if entry == "powm" else powm.device_modmul
                for route in ("rns", "cios"):
                    forced = route == "rns"

                    def call():
                        with powm.forced_rns_route() if forced else contextlib.nullcontext():
                            return fn(bases, other, moduli, dev)

                    call()  # warm: builds, caches, contexts
                    walls = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        call()
                        walls.append(time.perf_counter() - t0)
                    kern, busy = device_times(call, 3, SYMBOLS[entry, route])
                    row = {"entry": entry, "route": route, "width": width,
                           "exp_bits": exp_bits, "rows": rows,
                           "wall_ms": statistics.median(walls) * 1e3,
                           "kernel_ms": kern, "busy_ms": busy}
                    table.append(row)
                    print(json.dumps(row), flush=True)
    group_counts = [int(g) for g in args.groups.split(",") if g]
    comb = comb_cells(dev, rng, args.reps, group_counts) if "comb" in cells else []
    if comb:
        for line in comb_verdict(comb):
            print(line, flush=True)
    lanes = lanes_cells(dev, rng, args.reps) if "lanes" in cells else []
    mont_rows = [int(r) for r in args.mont_mul_rows.split(",") if r]
    mont = mont_mul_cells(dev, rng, args.reps, row_counts=mont_rows) if "mont_mul" in cells else []
    ladder_widths = [int(k) for k in args.ladder_widths.split(",") if k]
    ladder = (ladder_cells(dev, rng, args.reps, widths=ladder_widths) if "ladder" in cells
              else [])
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"device": smi, "rows": table, "comb": comb, "lanes": lanes,
                       "mont_mul": mont, "ladder": ladder}, fh, indent=1)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
