#!/usr/bin/env python3
"""Where the block product's time goes: cycles per phase of `mont_mul_block`
(csrc/cios_kernels.cu) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card:

    python3 scripts/block_product_phases.py [--src PATH/cios_kernels.cu]
                                            [--out FILE.json]

Copies the source with probes added (the source itself has none): at the
entry of `mont_mul_block` and after each of its block barriers, thread 0
of block 0 reads `clock64()` and adds the cycles since its last probe to
that phase's sum. The phases: `between` (from the last product's end to
this one's entry: the row loop's own work), `T` (x * y's column sums),
`T_norm` (T's normalisation, its lookahead's barrier inside), `m` (the
digit's column sums), `m_norm`, `mn` (m * n's column sums), `U_norm` (U's
normalisation with the subtraction). The copy is built with the port's
flags and run at (K, rows) = (256, 132), (256, 256), (128, 132) and (128,
264), widths (2048, 256) (one and two blocks a SM at the two widths),
on the Straus kernel at 256 threads a block, and the ladder at (128, 16
groups, 2048 bits). Prints cycles a product per phase, their sum, and
the SM clock (nvidia-smi's maximum), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PHASES = ("between", "T", "T_norm", "m", "m_norm", "mn", "U_norm")

_PROBES = """
__device__ unsigned long long g_probe_sum[8];  // cycles per phase; [7]: products
__device__ unsigned long long g_probe_last;

__device__ __forceinline__ void probe(int phase) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const unsigned long long t = clock64();
  if (phase == 0) {
    if (g_probe_sum[7]) g_probe_sum[0] += t - g_probe_last;
    g_probe_sum[7] += 1;
  } else {
    g_probe_sum[phase] += t - g_probe_last;
  }
  g_probe_last = t;
}

"""

_READ = """
extern "C" int fsdkr_probe_read(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_probe_sum, sizeof(g_probe_sum));
  if (err == cudaSuccess && reset) {
    unsigned long long zero[8] = {};
    err = cudaMemcpyToSymbol(g_probe_sum, zero, sizeof(zero));
  }
  return (int)err;
}
"""


def probed_source(text: str) -> str:
    """The source with the probes in `mont_mul_block`."""
    head = "template <int NT>\n__device__ __forceinline__ void mont_mul_block("
    start = text.index(head)
    body = text.index("{", start) + 1
    end = text.index("\n}\n", body)
    inner = text[body:end]
    count = inner.count("__syncthreads();")
    if count != 6:
        sys.exit(f"block_product_phases: mont_mul_block has {count} barriers, expected 6")
    n = iter(range(1, 7))
    inner = re.sub(r"__syncthreads\(\);", lambda m: f"__syncthreads(); probe({next(n)});", inner)
    text = text[:start] + _PROBES + text[start:body] + "\n  probe(0);" + inner + text[end:]
    return text + _READ


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "fsdkr_tpu_torch" / "csrc" / "cios_kernels.cu"))
    ap.add_argument("--seed", type=int, default=16)
    ap.add_argument("--out", default="fsdkr_tpu_torch/build/block_product_phases.json")
    args = ap.parse_args()

    import random

    import torch

    from fsdkr_tpu_torch.ops.nvcc_build import build_library

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda", 0)
    rng = random.Random(args.seed)
    cs.log(cs.smi_line())
    build = ROOT / "fsdkr_tpu_torch" / "build" / "probed"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "cios_kernels_probed.cu"
    src.write_text(probed_source(Path(args.src).read_text()))
    info = build_library(src)
    lib = ctypes.CDLL(info["so"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fsdkr_cios_multi_modexp_threads.argtypes = [i, p, p, i, ctypes.POINTER(i), i, p, p, p, p,
                                                    i, i, p, p]
    lib.fsdkr_cios_multi_modexp_threads.restype = i
    lib.fsdkr_cios_comb_ladder_threads.argtypes = [i, p, p, p, p, i, i, i, p, p]
    lib.fsdkr_cios_comb_ladder_threads.restype = i
    lib.fsdkr_probe_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), i]
    lib.fsdkr_probe_read.restype = i
    clock = cs.max_sm_clock_hz()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sums = (ctypes.c_ulonglong * 8)()

    def read(reset):
        torch.cuda.synchronize()
        if lib.fsdkr_probe_read(sums, reset):
            cs.fail("fsdkr_probe_read failed")
        return list(sums)

    results = []

    def report(label, run):
        run()  # warm
        read(True)
        run()
        got = read(True)
        products = got[7]
        per = {ph: got[j] / products for j, ph in enumerate(PHASES)}
        total = sum(per.values())
        cs.log(f"{label}: {products} products of block 0; cycles a product "
               + ", ".join(f"{ph} {v:.0f}" for ph, v in per.items())
               + f"; total {total:.0f} ({total / clock * 1e6:.3f} us at {clock / 1e6:.0f} MHz)")
        results.append({"case": label, "products": products, "cycles": per, "total": total})

    for k, rows in ((256, 132), (256, 256), (128, 132), (128, 264)):
        widths = (2048, 256)
        bases, exps, n, ni, r2, one = cs.multi_inputs(rng, dev, k, rows, widths, rows // 2)
        out = torch.empty_like(n)
        eb = (ctypes.c_int * 2)(*widths)

        def run():
            err = lib.fsdkr_cios_multi_modexp_threads(
                256, bases.data_ptr(), exps.data_ptr(), exps.shape[2], eb, 2, n.data_ptr(),
                ni.data_ptr(), r2.data_ptr(), one.data_ptr(), rows, k, out.data_ptr(), stream)
            if err:
                cs.fail(f"fsdkr_cios_multi_modexp_threads: CUDA error {err}")

        report(f"cios_multi_modexp K={k} rows={rows} widths={widths} at 256 threads", run)
    k, groups, w_cnt = 128, 16, 512
    _, _, base, n, ni, r2, _ = cs.comb_inputs(rng, dev, k, groups, 1, 2048, 0)
    powers = torch.empty((w_cnt, groups, k), dtype=torch.int32, device=dev)

    def ladder():
        err = lib.fsdkr_cios_comb_ladder_threads(256, base.data_ptr(), n.data_ptr(),
                                                 ni.data_ptr(), r2.data_ptr(), groups, k, w_cnt,
                                                 powers.data_ptr(), stream)
        if err:
            cs.fail(f"fsdkr_cios_comb_ladder_threads: CUDA error {err}")

    report(f"cios_comb_ladder K={k} groups={groups} exp_bits=2048 at 256 threads", ladder)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"smi": cs.smi_line(), "clock_hz": clock, "results": results}, f, indent=1)
    cs.log(cs.smi_line())


if __name__ == "__main__":
    main()
