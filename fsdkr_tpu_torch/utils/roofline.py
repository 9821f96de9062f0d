"""Roofline / MFU accounting for the modexp and EC kernel families on
the H100 (an own copy of fsdkr_tpu/utils/roofline.py, divided by the
card's peak instead of a TPU's).

proofs/s alone cannot tell "fast" from "busy": a collect() that spends
its time in host orchestration and one that keeps the card busy can post
the same throughput at small n. Each device launch therefore reports an
*analytic* MAC count (16x16-bit partial products, the word both
arithmetic families price: the CIOS limb product and the RNS channel
product) to the tracer, which divides by wall-clock and the card's peak
to give a model-flops utilization per phase.

Peak: the H100 SXM's dense int8 tensor-core rate, 1,979 TOP/s
(`INT8_OPS_PER_S`). A 16x16-bit multiply-add counts as four 8-bit
multiply-adds of two operations each — the least work an exact
tensor-core route could do — so the 16-bit MAC peak is
`H100_PEAK_MACS = INT8_OPS_PER_S / 8`, 247.4e12 MAC/s. The same model
sets chip_smoke.py's `bound_ms`, with `HBM_BYTES_PER_S` (3.35 TB/s) for
the bytes side. The number is an engineering roofline (analytic op
counts, padded rows included — padding is real device work), not a
profiler measurement; `telemetry.spans.torch_profile` gives the card's
own timeline.

The modexp formulas count only multiply work (the >95% term); additions,
selects and layout ops ride along. The EC formulas count device EC's
field products as its kernels compute them (`ec_scalar_mul_macs`,
`ec_tree_sum_macs`).
"""

from __future__ import annotations

__all__ = [
    "HBM_BYTES_PER_S",
    "INT8_OPS_PER_S",
    "H100_PEAK_MACS",
    "montmul_macs",
    "generic_modexp_macs",
    "shared_modexp_macs",
    "modmul_macs",
    "ec_scalar_mul_macs",
    "ec_tree_sum_macs",
    "k16",
    "stamp_generic_host",
    "stamp_shared_host",
]

# H100 SXM published peaks (dense): device memory rate and int8
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# 16x16-bit MACs/s: one such MAC is four int8 MACs of two operations each
H100_PEAK_MACS = INT8_OPS_PER_S / 8


def montmul_macs(k: int) -> float:
    """16-bit MACs per k-limb Montgomery multiply.

    CIOS: the product scan and the reduction scan each run k x (k+1)
    limb multiplies -> ~2k^2. The RNS equivalent (one MontMul = two
    base-extension matmuls of shape (rows, k) @ (k, k+1) plus O(k)
    channel ops) prices the same to leading order, so one formula serves
    both routes.
    """
    return 2.0 * k * k


def generic_modexp_macs(rows: int, exp_bits: int, k: int) -> float:
    """Generic windowed (4-bit) kernel: per row, exp_bits squarings +
    exp_bits/4 table muls + ~17 fixed muls (15 table entries, domain
    enter/exit)."""
    montmuls = rows * (exp_bits + exp_bits // 4 + 17)
    return montmuls * montmul_macs(k)


def shared_modexp_macs(
    groups: int, rows_per_group: int, windows: int, k: int
) -> float:
    """Fixed-base comb: accumulation is `windows` MontMuls per row; the
    16-entry tables are ~15 products per (window, group); the device
    power ladder is 4 squarings per (window, group)."""
    montmuls = windows * (groups * rows_per_group + 19 * groups)
    return montmuls * montmul_macs(k)


def modmul_macs(rows: int, k: int) -> float:
    """One MontMul per row plus domain enter/exit (~3 total)."""
    return rows * 3 * montmul_macs(k)


# 16x16-bit multiply-adds of device EC's field arithmetic (a 32x32-bit
# word product is four of them, its low half three, a product by a
# constant under 2^16 two): x * y of 8 x 8 words 256; a squaring 144 (36
# word products); the reduction on p's special form 40 (a word's m = T_i
# p^{-1} mod 2^32, 3, and m * 977, 2); a product by 3 or b3 = 21 17 (a
# word's 2, and 2^256 folded back as 2^32 + 977, 1).
MUL_MACS, SQR_MACS, REDUCE_MACS, SMALL_MACS = 256, 144, 40, 17
# a complete addition: 12 products, each reduced, and 3 by small
# constants; its doubling instance takes six of the 12 as squarings
EC_ADD_MACS = 12 * (MUL_MACS + REDUCE_MACS) + 3 * SMALL_MACS
EC_DOUBLE_MACS = 6 * (SQR_MACS + MUL_MACS) + 12 * REDUCE_MACS + 3 * SMALL_MACS


def ec_scalar_mul_macs(rows: int, scalar_bits: int) -> float:
    """One `ec_scalar_mul` launch: per row the 16-entry table's 14
    additions, then per 4-bit window 4 doublings and one addition."""
    windows = scalar_bits // 4
    return float(rows * ((14 + windows) * EC_ADD_MACS + 4 * windows * EC_DOUBLE_MACS))


def ec_tree_sum_macs(rows: int, groups: int) -> float:
    """One `ec_tree_sum` launch: M - 1 additions a group of M rows."""
    return float(max(0, rows - groups) * EC_ADD_MACS)


# ---------------------------------------------------------------------------
# Host-engine stamping: the prover, CRT and precompute phases run through
# the host engines; these helpers give them the same 16-bit MAC pricing
# (analytic; measured time stays the profiler's), attributed to the
# innermost active phase.

def k16(mod_bits: int) -> int:
    """Width in 16-bit limbs — the unit every formula above prices."""
    return max(1, (int(mod_bits) + 15) // 16)


def stamp_generic_host(rows: int, exp_bits: int, mod_bits: int) -> None:
    """Stamp a host generic-modexp batch (CPython pow, the native core,
    the CRT legs): rows x (exp_bits squarings + exp_bits/4 muls)."""
    from ..telemetry.spans import get_tracer

    tr = get_tracer()
    if not tr.enabled or rows <= 0 or exp_bits <= 0:
        return
    tr.add_macs(generic_modexp_macs(rows, exp_bits, k16(mod_bits)))


def stamp_shared_host(
    groups: int, rows_per_group: int, exp_bits: int, mod_bits: int
) -> None:
    """Stamp a host fixed-base comb batch (the native core's
    modexp_shared)."""
    from ..telemetry.spans import get_tracer

    tr = get_tracer()
    if not tr.enabled or rows_per_group <= 0 or exp_bits <= 0:
        return
    windows = max(1, exp_bits // 4)
    tr.add_macs(
        shared_modexp_macs(groups, rows_per_group, windows, k16(mod_bits))
    )
