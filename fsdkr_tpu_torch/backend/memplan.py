"""Bytes-budgeted tile plan of the verifier's row axes (the JAX package's
backend/memplan.py, with the same plan arithmetic).

The monolithic pair verify stages every pair row of a batch at once:
limb copies of the modexp columns, the per-row integer columns of both
families, fold buffers. At the north-star shape (n=256, 2048-bit
Paillier, M=256) that is 65,536 4096-bit rows, well past a gigabyte of
staged operands. The plan cuts a row axis into tiles whose staged bytes,
with two tiles in flight (`utils.pipeline.prefetch_tiles` prepares tile
k+1 while tile k's launches run), stay under the budget
(`mem_budget_bytes`):

- `plan_rows` cuts the rows. Tile sizes come ONLY from public
  quantities, the row count and the batch's width bucket
  (`pair_row_bytes`), so the plan leaks no secret-dependent structure.
- `stage` / `release` account the live staged-tile bytes, as the
  estimate `pair_row_bytes` gives them, with a high-water mark;
  `mem_stats()` reads the plan's gauges and counters (a module-level
  dict, where the JAX package keeps its `fsdkr_mem_*` metrics in its
  telemetry registry).
- `streamed_rows` runs a row-local verdict call tile by tile (collect's
  Feldman rows ride it).

The pair plan's consumer is `CudaBatchVerifier._verify_pairs_streamed`.
A batch that fits the budget is one tile and takes the monolithic path;
verdicts and blame are the same at every budget.

Left out of the copy: the mesh-aligned cut (it comes with multi-GPU) and
the serving fault plan's budget squeeze (it comes with serving).
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "mem_budget_bytes",
    "pair_row_bytes",
    "ec_row_bytes",
    "TilePlan",
    "plan_rows",
    "stage",
    "release",
    "count_tile",
    "streamed_rows",
    "mem_stats",
    "stats_reset",
]

_DEFAULT_BUDGET = 256 << 20

# Staged bytes of one pair row (a PDL and an Alice range row verified
# together): the limb copies of the modexp columns (u32 limbs of 16 bits,
# twice the value's bytes), both families' per-row integer columns and
# engine scratch, from the PUBLIC width bucket only.
_PAIR_ROW_FACTOR = 16
_PAIR_ROW_BASE = 512  # EC points, object headers, span bookkeeping

# tiles in flight: prefetch_tiles holds the next tile's prepared state
# while the current one's launches run
_INFLIGHT = 2


def mem_budget_bytes(device=None) -> int:
    """The staged-bytes budget, read at call time: FSDKRC_MEM_BUDGET_MB
    (MiB, a float) where it is set; else, on a CUDA device, half of the
    device memory free at the call (`torch.cuda.mem_get_info`); else
    256 MiB, the JAX package's default. A budget below one row's estimate
    gives 1-row tiles: the plan never refuses to run. Under a serving
    fault plan the `mem_squeeze` site may shrink one decision's budget
    by the plan's squeeze factor (verdicts do not depend on the budget,
    only the tiles do)."""
    return _fault_squeeze(_budget(device))


def _budget(device) -> int:
    raw = os.environ.get("FSDKRC_MEM_BUDGET_MB")
    if raw is not None:
        try:
            return max(1, int(float(raw) * (1 << 20)))
        except ValueError:
            pass
    if device is not None:
        import torch

        device = torch.device(device)
        if device.type == "cuda":
            free, _total = torch.cuda.mem_get_info(device)
            return max(1, free // 2)
    return _DEFAULT_BUDGET


# the serving fault plan, looked up and never imported: zero cost unless
# a chaos run configured one
_FAULTS_MODULE = __name__.rsplit(".", 2)[0] + ".serving.faults"


def _fault_squeeze(budget: int) -> int:
    m = sys.modules.get(_FAULTS_MODULE)
    if m is None:
        return budget
    plan = m.active()
    return budget if plan is None else plan.squeeze_budget(budget)


def pair_row_bytes(nn_bits: int, nt_bits: int) -> int:
    """Staged bytes of one pair row at the batch's public width bucket
    (the mod-n^2 and mod-N~ widths rounded up to whole limbs)."""
    from ..ops.limbs import LIMB_BITS, limbs_for_bits

    nn_b = limbs_for_bits(max(1, nn_bits)) * (LIMB_BITS // 8)
    nt_b = limbs_for_bits(max(1, nt_bits)) * (LIMB_BITS // 8)
    return _PAIR_ROW_FACTOR * (nn_b + nt_b) + _PAIR_ROW_BASE


def ec_row_bytes() -> int:
    """Staged bytes of one Feldman/EC row (points, scalars, MSM staging;
    the curve's width is fixed)."""
    return 1024


@dataclass(frozen=True)
class TilePlan:
    """One tiling of a row axis: `tiles` are [lo, hi) spans, `inflight`
    the tiles staged at once (the budget divides by it)."""

    rows: int
    row_bytes: int
    budget: int
    inflight: int
    tile_rows: int
    tiles: Tuple[Tuple[int, int], ...]

    def tile_bytes(self, rows: int) -> int:
        return rows * self.row_bytes

    @property
    def multi_tile(self) -> bool:
        return len(self.tiles) > 1


def plan_rows(rows: int, row_bytes: int, label: str = "pairs",
              device=None) -> Optional[TilePlan]:
    """Cut `rows` into tiles whose in-flight staged bytes fit the budget
    (`mem_budget_bytes(device)`); None when there is nothing to cut.
    Tiles are at least one row."""
    if rows <= 0 or row_bytes <= 0:
        return None
    budget = mem_budget_bytes(device)
    tile = min(max(1, budget // (row_bytes * _INFLIGHT)), rows)
    tiles = tuple((lo, min(lo + tile, rows)) for lo in range(0, rows, tile))
    _record_plan(label, rows, budget, tile, len(tiles))
    return TilePlan(rows=rows, row_bytes=row_bytes, budget=budget, inflight=_INFLIGHT,
                    tile_rows=tile, tiles=tiles)


# ---------------------------------------------------------------------------
# The plan's gauges (the latest plan, by family) and counters (since the
# last stats_reset), and the staged bytes' high-water mark.

_LOCK = threading.Lock()
_STATS: Dict[str, object] = {}


def _fresh() -> Dict[str, object]:
    return {"budget_bytes": 0, "tile_rows": {}, "plan_rows": {}, "tiles": {},
            "plans": 0, "multi_tile_plans": 0, "staged_bytes_est": 0,
            "peak_staged_bytes_est": 0}


_STATS.update(_fresh())


def _record_plan(label, rows, budget, tile, n_tiles) -> None:
    with _LOCK:
        _STATS["budget_bytes"] = budget
        _STATS["tile_rows"][label] = tile
        _STATS["plan_rows"][label] = rows
        _STATS["plans"] += 1
        _STATS["multi_tile_plans"] += n_tiles > 1


def count_tile(label: str) -> None:
    with _LOCK:
        _STATS["tiles"][label] = _STATS["tiles"].get(label, 0) + 1


def stage(nbytes: int) -> None:
    """Account a tile's estimated staged bytes as live (before its
    verify)."""
    with _LOCK:
        _STATS["staged_bytes_est"] += nbytes
        _STATS["peak_staged_bytes_est"] = max(_STATS["peak_staged_bytes_est"],
                                              _STATS["staged_bytes_est"])


def release(nbytes: int) -> None:
    """Release a tile's accounted bytes (after its verify)."""
    with _LOCK:
        _STATS["staged_bytes_est"] = max(0, _STATS["staged_bytes_est"] - nbytes)


def mem_stats() -> dict:
    """The plan's state: the latest plan's budget, its tile and total
    rows by family, tiles run by family, plans made (and how many cut more
    than one tile), and the live staged bytes and their high-water mark,
    both as `pair_row_bytes` / `ec_row_bytes` estimate them (not a
    measurement of device memory)."""
    with _LOCK:
        return {key: dict(v) if isinstance(v, dict) else v for key, v in _STATS.items()}


def stats_reset() -> None:
    """Zero the counters and the high-water mark for a fresh window."""
    with _LOCK:
        _STATS.update(_fresh())


# ---------------------------------------------------------------------------


def streamed_rows(call, items: Sequence, row_bytes: int, label: str, device=None) -> List:
    """A ROW-LOCAL verdict call (each row's verdict a function of that row
    alone: a batched check must fall back to exact per-row checks where it
    fails, as `validate_feldman` does) run tile by tile under the plan and
    concatenated. A one-tile plan calls through."""
    plan = plan_rows(len(items), row_bytes, label=label, device=device)
    if plan is None or not plan.multi_tile:
        return call(items)
    out: List = []
    for lo, hi in plan.tiles:
        nbytes = plan.tile_bytes(hi - lo)
        stage(nbytes)
        try:
            count_tile(label)
            out.extend(call(items[lo:hi]))
        finally:
            release(nbytes)
    return out
