#!/usr/bin/env python3
"""Count the SASS instructions of one CIOS step in the built CIOS kernels.

Run from the root of a checkout, on a machine with the CUDA toolkit:

    python3 scripts/cios_sass_count.py [--src PATH/cios_kernels.cu]
                                       [--kernel cios_comb_kernel] [--all-loops]
                                       [--out FILE.json]

Builds the source (default: this checkout's
fsdkr_tpu_torch/csrc/cios_kernels.cu; another tree's source builds the
same way, into this checkout's build directory) with the port's nvcc
flags, disassembles it with `cuobjdump -sass`, and, in every
instantiation of each kernel named by `--kernel` (a substring of the
mangled name), finds the product's step loop: the innermost loop (a
backward branch) that holds shuffles. Its body holds P steps, P the last
template argument (words a lane); the lanes a row are the template's
first argument where there are two, else 32. Per step it prints the
instructions by class:

  multiply-add  IMAD, IMAD.WIDE, IMAD.HI, IMAD.X (not IMAD.MOV/IADD/SHL)
  integer       IADD3, LOP3, SEL, ISETP, SHF, LEA, PRMT, IMAD.IADD/SHL, ...
  shuffle       SHFL
  move          MOV, IMAD.MOV
  control       BRA, BSSY, BSYNC, WARPSYNC, NOP, ...
  memory        LD*, ST*

and per row-step (a step of one row: per step x lanes / 32). From the
per-row-step count it prints the issue-bound time of `cios_comb` at the
main path's shape (16 groups x 256 rows, K=128, 2048-bit exponents: 513
products of 64 steps a row) on the card's 528 schedulers at its maximum
SM clock (nvidia-smi), at one instruction a cycle and at two (the
integer and multiply pipes take 16 lanes a cycle). For a one-warp-a-group
ladder kernel (`cios_comb_ladder_kernel` with one template argument, P)
it prints instead the issue time of the ladder's chain at the main
path's shape (2045 products of 64 steps, one warp a scheduler) at one
instruction a cycle.

`--all-loops` also prints every innermost loop (a backward branch with
no loop inside) of the named kernels, shuffles or not, with its
instructions by class and per `IMAD.WIDE` (for the block ladder's
column-sum loops: one `IMAD.WIDE` a word product).

The joint kernels (`cios_multi_modexp_kernel`, `cios_shared_exp_kernel`)
are named by default too. A one-warp form (template argument P, words a
lane) gets its step count and its SASS per product at K = 64P (W = 32P
steps a product). A block form (template argument NT, threads a block,
on the ladder's block product) gets every innermost loop as
`--all-loops` prints it, and its column sums' SASS per product at K=256:
the column-sum loops' (8 or more `IMAD.WIDE`) instructions per
`IMAD.WIDE` times the 2.5 W^2 word products a product does (W^2 for x y,
W^2 / 2 for the digit, W^2 for m n), over 32 lanes: warp instructions,
the normalisations and barriers not counted.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

SCHEDULERS = 132 * 4  # H100 SXM: 132 SMs, 4 schedulers each
JOINT = ("cios_multi_modexp_kernel", "cios_shared_exp_kernel")
BLOCK_K = 256  # the joint kernels' main-path width (the collect's 2048-bit rows)
# cios_comb on the main path: groups x rows, products a row, steps a product
MAIN_ROW_STEPS = 16 * 256 * (2048 // 4 + 1) * (128 // 2)
# the ladder on the main path: products along a group's chain, steps a product
LADDER_STEPS = (1 + 4 * (2048 // 4 - 1)) * (128 // 2)

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET_LABEL = re.compile(r"`\((\.L_x_\d+)\)")
_TARGET_ADDR = re.compile(r"\b0x([0-9a-f]+)\b")


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base == "SHFL":
        return "shuffle"
    if base == "MOV" or op.startswith("IMAD.MOV") or base in ("MOV32I", "UMOV"):
        return "move"
    if base == "IMAD" and not op.startswith(("IMAD.IADD", "IMAD.SHL")):
        return "multiply-add"
    if base in ("BRA", "BSSY", "BSYNC", "WARPSYNC", "NOP", "BAR", "EXIT", "CALL", "RET",
                "YIELD", "BREAK", "JMP"):
        return "control"
    if base.startswith(("LD", "ST", "ULDC", "ATOM", "RED")):
        return "memory"
    return "integer"


def functions(sass: str):
    """{mangled name: [(kind, value)]}: kind "insn" (address, opcode,
    operands) or "label"."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            cur.append(("label", m.group(1)))
            continue
        m = _INSN.search(line)
        if m:
            cur.append(("insn", (int(m.group(1), 16), m.group(2), m.group(3))))
    return out


def step_loops(items, any_loop=False):
    """The innermost loops holding a shuffle (any_loop: every innermost
    loop): lists of (opcode, operands)."""
    insns, label_at, addr_at = [], {}, {}
    for kind, v in items:
        if kind == "label":
            label_at[v] = len(insns)
        else:
            addr_at[v[0]] = len(insns)
            insns.append(v)
    loops = []
    for i, (_, op, rest) in enumerate(insns):
        if not op.startswith("BRA"):
            continue
        m = _TARGET_LABEL.search(rest)
        t = label_at.get(m.group(1)) if m else None
        if t is None:
            m = _TARGET_ADDR.search(rest)
            t = addr_at.get(int(m.group(1), 16)) if m else None
        if t is not None and t <= i:
            loops.append((t, i))
    with_shfl = [(t, i) for t, i in loops
                 if any_loop or any(op.startswith("SHFL") for _, op, _ in insns[t:i + 1])]
    inner = [(t, i) for t, i in with_shfl
             if not any((a, b) != (t, i) and t <= a and b <= i for a, b in with_shfl)]
    return [[(op, rest) for _, op, rest in insns[t:i + 1]] for t, i in inner]


def template_ints(name: str):
    m = re.search(r"I((?:Li-?\d+E)+)E", name)
    return [int(v) for v in re.findall(r"Li(-?\d+)E", m.group(1))] if m else []


def max_sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except (ValueError, IndexError):
        return None


def block_product(name, items, dump):
    """A block form's innermost loops, and its column sums' warp
    instructions a product at K=BLOCK_K (module docstring)."""
    loops, col, wides = [], 0, 0
    for body in step_loops(items, any_loop=True):
        counts, ops = {}, {}
        for op, _ in body:
            counts[classify(op)] = counts.get(classify(op), 0) + 1
            ops[op] = ops.get(op, 0) + 1
        wide = sum(c for op, c in ops.items() if op.startswith("IMAD.WIDE"))
        loops.append({"body": len(body), "counts": counts, "imad_wide": wide,
                      **({"sass": [f"{op}{rest}" for op, rest in body]} if dump else {})})
        if wide >= 8:
            col += len(body)
            wides += wide
        print(f"{name}: innermost loop of {len(body)} instructions ("
              + ", ".join(f"{c} {v}" for c, v in sorted(counts.items())) + ")"
              + (f", {len(body) / wide:.2f} a product over its {wide} IMAD.WIDE"
                 if wide else ""), flush=True)
    w = BLOCK_K // 2
    per_wide = col / wides if wides else None
    per_product = per_wide * 2.5 * w * w / 32 if per_wide else None
    print(f"{name}: column-sum loops {col} instructions over {wides} IMAD.WIDE"
          + (f" ({per_wide:.2f} each): about {per_product:.0f} warp instructions of column "
             f"sums a product at K={BLOCK_K}" if per_wide else ""), flush=True)
    return {"kernel": name, "block": True, "loops": loops, "column_sum_per_wide": per_wide,
            "column_sum_warp_insns_per_product": per_product, "per_product_k": BLOCK_K}


def main():
    here = Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(here / "fsdkr_tpu_torch" / "csrc" / "cios_kernels.cu"))
    ap.add_argument("--kernel", action="append",
                    help="substring of a kernel's mangled name (default: cios_comb_kernel, "
                         "cios_mont_mul, cios_comb_ladder_kernel)")
    ap.add_argument("--all-loops", action="store_true",
                    help="also count every innermost loop of the named kernels")
    ap.add_argument("--out", help="also write the counts to this JSON file")
    ap.add_argument("--dump", action="store_true",
                    help="also write each step loop's SASS text to the JSON file")
    args = ap.parse_args()
    kernels = args.kernel or ["cios_comb_kernel", "cios_mont_mul", "cios_comb_ladder_kernel",
                              *JOINT]
    sys.path.insert(0, str(here))
    from fsdkr_tpu_torch.ops.nvcc_build import build_library

    so = build_library(Path(args.src).resolve())["so"]
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = Path(home) / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool) if tool.exists() else "cuobjdump", "-sass", so],
                          capture_output=True, text=True, check=True).stdout
    clock = max_sm_clock_hz()
    print(f"source {args.src}; library {so}; max SM clock "
          f"{clock / 1e6 if clock else 'not read'} MHz", flush=True)
    rows = []
    for name, items in sorted(functions(sass).items()):
        if not any(k in name for k in kernels):
            continue
        ints = template_ints(name)
        p = ints[-1] if ints else 1
        lanes = ints[0] if len(ints) == 2 else 32
        joint = any(k in name for k in JOINT)
        block = joint and p >= 128  # a block form: the template argument is NT
        if block:
            rows.append(block_product(name, items, args.dump))
        for body in () if block else step_loops(items):
            counts = {}
            for op, _ in body:
                counts[classify(op)] = counts.get(classify(op), 0) + 1
            ops = {}
            for op, _ in body:
                ops[op] = ops.get(op, 0) + 1
            per_step = {c: v / p for c, v in counts.items()}
            total = sum(per_step.values())
            row_step = total * lanes / 32
            row = {"kernel": name, "lanes": lanes, "words_per_lane": p,
                   "body": len(body), "per_step": per_step, "per_step_total": total,
                   "per_row_step": row_step, "opcodes": ops}
            if args.dump:
                row["sass"] = [f"{op}{rest}" for op, rest in body]
            ladder = "cios_comb_ladder_kernel" in name
            if joint:
                row["per_product_k"] = 64 * p
                row["per_product"] = total * 32 * p
                bound = (f"; a product at K={64 * p} ({32 * p} steps): "
                         f"{row['per_product']:.0f} warp instructions")
            elif clock and ladder:
                row["ladder_main_issue_ms"] = LADDER_STEPS * total / clock * 1e3
                bound = (f"; ladder main-path chain at one warp a scheduler "
                         f"{row['ladder_main_issue_ms']:.3f} ms at 1 instruction a cycle")
            elif clock:
                row["comb_main_issue_ms"] = {
                    cycles: MAIN_ROW_STEPS * row_step * cycles / (SCHEDULERS * clock) * 1e3
                    for cycles in (1, 2)}
                bound = (f"; cios_comb main-path issue bound "
                         f"{row['comb_main_issue_ms'][1]:.3f} ms at 1 instruction a cycle, "
                         f"{row['comb_main_issue_ms'][2]:.3f} ms at 2")
            else:
                bound = ""
            rows.append(row)
            print(f"{name} (L={lanes}, P={p}): loop body {len(body)} instructions; per step "
                  f"{total:.2f} ("
                  + ", ".join(f"{c} {v:.2f}" for c, v in sorted(per_step.items()))
                  + f"); per row-step {row_step:.2f}" + bound, flush=True)
            print("  opcodes: " + ", ".join(f"{op} {c}" for op, c in
                                            sorted(ops.items(), key=lambda kv: -kv[1])),
                  flush=True)
        for body in step_loops(items, any_loop=True) if args.all_loops and not block else ():
            counts, ops = {}, {}
            for op, _ in body:
                counts[classify(op)] = counts.get(classify(op), 0) + 1
                ops[op] = ops.get(op, 0) + 1
            wide = sum(c for op, c in ops.items() if op.startswith("IMAD.WIDE"))
            row = {"kernel": name, "loop": "innermost", "body": len(body), "counts": counts,
                   "imad_wide": wide, "opcodes": ops}
            if args.dump:
                row["sass"] = [f"{op}{rest}" for op, rest in body]
            rows.append(row)
            print(f"{name}: innermost loop of {len(body)} instructions ("
                  + ", ".join(f"{c} {v}" for c, v in sorted(counts.items())) + ")"
                  + (f", {len(body) / wide:.2f} a product over its {wide} IMAD.WIDE"
                     if wide else ""), flush=True)
    if not rows:
        sys.exit("cios_sass_count: no step loop found in the named kernels")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"source": args.src, "clock_hz": clock, "loops": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
