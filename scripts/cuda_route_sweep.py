#!/usr/bin/env python3
"""Time the two device arithmetic families of the PyTorch/CUDA port
against each other on one NVIDIA GPU: the RNS route (kernel 2 / kernel 1)
and the CIOS engine, over the row counts and widths of the refresh's
columns. The routing threshold of fsdkr_tpu_torch/backend/powm.py is
read off this table.

Run from the root of a checkout, on a machine with the card:

    python3 scripts/cuda_route_sweep.py [--rows 8,16,...] [--out FILE.json]

For every (entry point, modulus width, exponent width, rows): the whole
`device_powm` / `device_modmul` call, through the CIOS engine as routed
and through the RNS route inside `forced_rns_route()` (the cache warm:
one call first), timed on the host clock (median of 3 calls, each
ending in its host copy), and its device time per call under
torch.profiler: the route's kernel
(`kernel_ms`) and every device event (`busy_ms`). Rows share 16 distinct
moduli, as a refresh's columns do (one modulus per party).
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
SYMBOLS = {("powm", "rns"): "rns_modexp_kernel", ("powm", "cios"): "cios_modexp_kernel",
           ("modmul", "rns"): "rns_mont_mul_kernel", ("modmul", "cios"): "cios_modmul_kernel"}


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the table to this JSON file")
    ap.add_argument("--seed", type=int, default=6)
    ap.add_argument("--rows", default=",".join(map(str, ROWS)),
                    help="comma-separated row counts (default: 8 .. 16384)")
    args = ap.parse_args()
    row_counts = [int(r) for r in args.rows.split(",") if r]

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
    for width in WIDTHS:
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
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"device": smi, "rows": table}, fh, indent=1)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
