"""Batched modular exponentiation and multiplication columns.

`distribute`'s per-receiver fan-out and every verifier family are
expressed against a `batch_powm(bases, exps, moduli) -> list[int]`
callable:

- host_powm: CPython pow loop (oracle).
- device_powm_grouped: the device's batch powm (`get_batch_powm`, the
  verifier's `_modexp`): rows that share a (base, modulus) pair in
  groups of at least `_SHARED_MIN_ROWS` take the fixed-base comb
  (device_powm_shared, ops.montgomery.shared_base_modexp), the rest the
  generic engine. device_powm_batches runs it over several batches at
  once, the generic rows of all of them in one segmented launch: what
  powm_columns does with its width batches on the device.
- device_powm: bases^exps mod N per row on the device, through the CIOS
  engine (ops.montgomery, `fsdkr_cios_modexp`) at every width. An H100
  sweep put the CIOS engine ahead of the RNS route at every launch size,
  so the RNS route (ops.rns, kernel 2) takes a launch only inside
  `forced_rns_route()`, within the RNS width classes.
- device_modmul: a*b mod N per row, the same way (`fsdkr_cios_modmul`,
  or kernel 1 in two launches when forced).

Batches are padded to powers of two (>= 8 rows, >= 2 comb groups;
padding rows and groups use modulus 3) so launch shapes repeat across
calls. The CIOS engine's
Montgomery contexts persist in the precompute cache (utils.lru), keyed
by the modulus vector.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable, List, Optional, Sequence

from ..config import ProtocolConfig
from ..ops.limbs import WINDOW_BITS, bucket_exp_bits, limbs_for_bits

BatchPowm = Callable[[Sequence[int], Sequence[int], Sequence[int]], List[int]]

# rows per launch: bounds the device staging of one launch
_MAX_ROWS = 16384

# modulus width classes with prepared RNS bases (caps distinct launch
# shapes; moduli bucket up to the nearest class). Wider moduli take a
# multiple of 1024 bits, up to the widest class the RNS kernels are held
# at on the card (7168 bits: kernel 2 holds 4 rows per block there);
# anything wider takes the CIOS engine.
_RNS_WIDTH_CLASSES = (256, 512, 1024, 1536, 2048, 3072, 4096)
_MAX_CLASS_BITS = 7168

# RNS/CIOS routing: a launch of at least _RNS_MIN_ROWS rows within the
# RNS width classes takes the RNS route, a smaller one the CIOS engine.
# On the H100 the CIOS engine was ahead of the RNS route in every cell of
# the sweep (PERF.md section 6, scripts/cuda_route_sweep.py: whole modexp
# and modmul calls at 8-16384 rows, 2048- and 4096-bit moduli, 256- and
# 2048-bit exponents), so the threshold sits above the largest launch and
# only `forced_rns_route()` sends a launch to the RNS route.
_RNS_MIN_ROWS = _MAX_ROWS + 1


@contextlib.contextmanager
def forced_rns_route():
    """Within the block, every device_powm / device_modmul launch within
    the RNS width classes takes the RNS route: for the checks and
    measurements that drive the RNS kernels (chip_smoke.py's RNS path,
    the route sweep, the tests of both routes)."""
    global _RNS_MIN_ROWS
    saved = _RNS_MIN_ROWS
    _RNS_MIN_ROWS = 0
    try:
        yield
    finally:
        _RNS_MIN_ROWS = saved


def _rns_forced() -> bool:
    """Inside `forced_rns_route()`."""
    return _RNS_MIN_ROWS == 0


# A launch's (base, modulus) groups of at least _SHARED_MIN_ROWS rows take
# the fixed-base comb, however few they are; every other row takes the
# generic engine. The JAX package's 4 rows were picked for the TPU. In the
# H100 comb sweep (PERF.md section 6, "The comb sweep";
# scripts/cuda_route_sweep.py --cells comb, the cache cold in every call)
# the comb has the shorter wall in every cell of 256 rows a group from 1
# group up, since the ladder runs one block a group on a full-width-digit
# product (with one warp a group it lost 3 of the 4 cells of 1 group of
# 256 rows), so there is no floor on the group count. Under 256
# rows a group it pays in most cells too, but that floor also decides the
# pair columns' per-receiver groups (16 rows at n=16): PERF.md section 7.
_SHARED_MIN_ROWS = 256


def _width_class(width: int) -> Optional[int]:
    """The RNS width class of a `width`-bit modulus, or None past the
    widest class (those widths take the CIOS engine)."""
    for cls in _RNS_WIDTH_CLASSES:
        if width <= cls:
            return cls
    cls = -(-width // 1024) * 1024
    return cls if cls <= _MAX_CLASS_BITS else None


def _pad_pow2(rows: int) -> int:
    return max(8, 1 << (rows - 1).bit_length())


def _padded(bases, exps, moduli):
    """A launch's rows padded to `_pad_pow2` rows with base 1, exponent 0,
    modulus 3."""
    pad = _pad_pow2(len(bases)) - len(bases)
    return list(bases) + [1] * pad, list(exps) + [0] * pad, list(moduli) + [3] * pad


def _cached_ctx(moduli, num_limbs, device):
    """The CIOS engine's context for a modulus vector on `device`, from
    the precompute cache. A refresh reuses the same modulus vectors across
    many launches and across collect() / distribute_batch() calls of a
    stable committee, so the per-row host precompute (n^{-1} mod R, R^2
    mod N, R mod N) and its upload are paid once per vector. Keyed by a
    hash of the vector with a full equality check on a hit, so a
    collision can only cost a rebuild. The moduli are public, and so is
    everything the context holds."""
    from ..ops.montgomery import BatchModExp
    from ..utils.lru import global_cache

    cache = global_cache()
    key = ("mont-ctx", hash(tuple(moduli)), num_limbs, str(device))
    ctx = cache.get(key) if cache.budget > 0 else None
    if ctx is None or ctx.ctx.moduli != list(moduli):
        ctx = BatchModExp(moduli, num_limbs, device)
        if cache.budget > 0:
            cache.put(key, ctx, ctx.nbytes())
    return ctx


def powm_cache_stats():
    """Counters of the persistent precompute cache (CIOS contexts and the
    RNS route's per-modulus constants): {entries, bytes, budget, hits,
    misses, evictions}."""
    from ..utils.lru import cache_stats

    return cache_stats()


def host_powm(bases, exps, moduli) -> List[int]:
    """Host batched modexp: CPython pow per row."""
    return [pow(b, e, m) for b, e, m in zip(bases, exps, moduli)]


def _tiled(fn, cols, device) -> List[int]:
    out: List[int] = []
    for lo in range(0, len(cols[0]), _MAX_ROWS):
        out += fn(*(c[lo : lo + _MAX_ROWS] for c in cols), device)
    return out


def device_powm(bases, exps, moduli, device="cuda") -> List[int]:
    """bases^exps mod moduli row-wise on `device` (counterpart of the JAX
    package's tpu_powm)."""
    if not bases:
        return []
    if len(bases) > _MAX_ROWS:
        return _tiled(device_powm, (bases, exps, moduli), device)
    b = len(bases)
    bases, exps, moduli = _padded(bases, exps, moduli)
    width = max(m.bit_length() for m in moduli)
    cls = _width_class(width)
    if b >= _RNS_MIN_ROWS and cls is not None:
        from ..ops.rns import rns_modexp

        return rns_modexp(bases, exps, moduli, cls, device)[:b]
    return _cached_ctx(moduli, limbs_for_bits(width), device).modexp(bases, exps)[:b]


def device_powm_shared(bases, exps_per_group, moduli, device="cuda") -> List[List[int]]:
    """bases[g]^exps_per_group[g][m] mod moduli[g] through the CIOS comb on
    `device` (counterpart of the JAX package's tpu_powm_shared; the RNS
    comb is not ported). Group count and rows per group are padded to
    powers of two (at least 2 groups and 8 rows: the 4 warps of a comb
    block then share one group; dummy groups use modulus 3, dummy rows
    exponent 0). Launches tile so that the 16 * W * G-row window table
    stays within _MAX_ROWS table rows, run one after another."""
    if not bases:
        return []
    w_cnt = max(1, bucket_exp_bits(e for grp in exps_per_group for e in grp) // WINDOW_BITS)
    m_max = max((len(e) for e in exps_per_group), default=1) or 1
    m_pad = _pad_pow2(m_max)
    budget = _MAX_ROWS
    # power-of-two chunks: a full chunk's padded size is the chunk itself
    row_chunk = max(8, 1 << (budget.bit_length() - 1))
    if m_pad > row_chunk:  # huge groups: tile the row axis
        parts = [
            device_powm_shared(bases, [e[lo : lo + row_chunk] for e in exps_per_group],
                               moduli, device)
            for lo in range(0, m_max, row_chunk)
        ]
        return [[v for part in parts for v in part[i]] for i in range(len(bases))]
    g_cap = max(1, 1 << max(0, min(budget // w_cnt, budget // m_pad).bit_length() - 1))
    if len(bases) > g_cap:  # tile the group axis
        return [
            grp
            for lo in range(0, len(bases), g_cap)
            for grp in device_powm_shared(bases[lo : lo + g_cap],
                                          exps_per_group[lo : lo + g_cap],
                                          moduli[lo : lo + g_cap], device)
        ]
    from ..ops.montgomery import shared_base_modexp

    g = len(bases)
    g_pad = max(2, 1 << (g - 1).bit_length())
    bases = list(bases) + [1] * (g_pad - g)
    moduli = list(moduli) + [3] * (g_pad - g)
    exps = [list(e) + [0] * (m_pad - len(e)) for e in exps_per_group]
    exps += [[0] * m_pad] * (g_pad - g)
    k = limbs_for_bits(max(m.bit_length() for m in moduli))
    out = shared_base_modexp(bases, exps, moduli, k, ctx=_cached_ctx(moduli, k, device))
    return [out[i][: len(exps_per_group[i])] for i in range(g)]


def device_powm_grouped(bases, exps, moduli, device="cuda") -> List[int]:
    """Like device_powm, but rows sharing a (base, modulus) pair in groups
    of at least _SHARED_MIN_ROWS take the fixed-base comb, and the rest the
    generic engine as device_powm runs them (counterpart of the JAX package's
    tpu_powm_grouped).
    That is the shape of the collect columns: ring-Pedersen rows share
    (T, N) per message, PDL and range rows (h1 | h2, N~) per receiver.
    Inside `forced_rns_route()` every row takes device_powm (the RNS
    comb is not ported). One batch of `device_powm_batches`."""
    return device_powm_batches([(bases, exps, moduli)], device)[0]


def _comb_rows(bases, exps, moduli, out, device) -> List[int]:
    """The batch's comb groups through device_powm_shared, their results
    into `out`; returns the indices of the other rows."""
    groups: dict = {}
    for i, (b, m) in enumerate(zip(bases, moduli)):
        groups.setdefault((b, m), []).append(i)
    shared = [(key, rows) for key, rows in groups.items() if len(rows) >= _SHARED_MIN_ROWS]
    if shared:
        res = device_powm_shared(
            [key[0] for key, _ in shared],
            [[exps[i] for i in rows] for _, rows in shared],
            [key[1] for key, _ in shared],
            device,
        )
        for (_, rows), vals in zip(shared, res):
            for i, v in zip(rows, vals):
                out[i] = v
    in_comb = {i for _, rows in shared for i in rows}
    return [i for i in range(len(bases)) if i not in in_comb]


def device_powm_batches(batches, device="cuda") -> List[List[int]]:
    """device_powm_grouped over several (bases, exps, moduli) batches at
    once. Each batch's comb groups launch as device_powm_grouped launches
    them; the other rows of every batch share one segmented `cios_modexp`
    launch (`ops.montgomery.modexp_batches`), downloaded once: a segment
    per batch, tiled and padded as device_powm tiles and pads it, on the
    same cached context, so results and cache keys are device_powm's. A
    launch holds at most _MAX_ROWS rows and MAX_SEGMENTS segments; more
    take more launches. Inside `forced_rns_route()` every batch takes
    device_powm."""
    if _rns_forced():
        return [device_powm(*batch, device) for batch in batches]
    from ..ops.montgomery import modexp_batches
    from ..ops.montgomery_kernels import MAX_SEGMENTS

    outs, jobs = [], []  # jobs: (ctx, bases, exps, out, row indices)
    for bases, exps, moduli in batches:
        out: List = [None] * len(bases)
        outs.append(out)
        rest = _comb_rows(bases, exps, moduli, out, device)
        for lo in range(0, len(rest), _MAX_ROWS):
            idx = rest[lo : lo + _MAX_ROWS]
            b, e, m = _padded(*([col[i] for i in idx] for col in (bases, exps, moduli)))
            ctx = _cached_ctx(m, limbs_for_bits(max(x.bit_length() for x in m)), device)
            jobs.append((ctx, b, e, out, idx))

    def launch(group):
        for (*_, out, idx), res in zip(group, modexp_batches([j[:3] for j in group])):
            for i, v in zip(idx, res):
                out[i] = v

    group, rows = [], 0
    for job in jobs:
        if group and (rows + len(job[1]) > _MAX_ROWS or len(group) == MAX_SEGMENTS):
            launch(group)
            group, rows = [], 0
        group.append(job)
        rows += len(job[1])
    if group:
        launch(group)
    return outs


def device_modmul(a, b, moduli, device="cuda") -> List[int]:
    """Row-wise a*b mod moduli on `device` (counterpart of the JAX
    package's tpu_modmul)."""
    if not a:
        return []
    if len(a) > _MAX_ROWS:
        return _tiled(device_modmul, (a, b, moduli), device)
    rows = len(a)
    pad = _pad_pow2(rows) - rows
    a = list(a) + [1] * pad
    b = list(b) + [1] * pad
    moduli = list(moduli) + [3] * pad
    width = max(m.bit_length() for m in moduli)
    cls = _width_class(width)
    if rows >= _RNS_MIN_ROWS and cls is not None:
        from ..ops.rns import rns_modmul

        return rns_modmul(a, b, moduli, cls, device)[:rows]
    return _cached_ctx(moduli, limbs_for_bits(width), device).modmul(a, b)[:rows]


def get_batch_powm(config: ProtocolConfig) -> BatchPowm:
    if config.backend == "host":
        return host_powm
    return partial(device_powm_grouped, device=config.torch_device())


def powm_columns(powm: BatchPowm, *columns):
    """Fuse several (bases, exps, moduli) columns into per-width batched
    launches and split the results back.

    Columns are fused ONLY within the same bucketed exponent width AND
    the same modulus limb width: a batch costs sequential depth
    proportional to its widest exponent and is sized by its widest
    modulus, so a narrow column riding a wide batch would pay for the
    width. Identical columns (the PDL and Alice provers both commit
    h1^x mod N~ over the same share column) share one computation.

    Where `powm` is device_powm_grouped bound to a device by `partial`
    (`get_batch_powm`, the verifier's `_modexp`), the batches go to
    device_powm_batches together: each batch is a segment of one
    `cios_modexp` launch, so the batches' chains run side by side.
    """
    by_prefix: dict = {}  # cheap prefix -> [column indices]
    alias: dict = {}  # later column index -> first column index
    flat: dict = {}  # width class -> (bases, exps, moduli, [(col, lo, hi)])
    for col, (bases, exps, moduli) in enumerate(columns):
        prefix = (
            len(bases),
            bases[0] if bases else 0,
            exps[0] if exps else 0,
            moduli[0] if moduli else 0,
        )
        dup = None
        for prev in by_prefix.get(prefix, ()):
            pb, pe, pm = columns[prev]
            if list(pb) == list(bases) and list(pe) == list(exps) and list(pm) == list(moduli):
                dup = prev
                break
        if dup is not None:
            alias[col] = dup
            continue
        by_prefix.setdefault(prefix, []).append(col)
        w = (
            bucket_exp_bits(exps),
            limbs_for_bits(max(m.bit_length() for m in moduli)) if moduli else 0,
        )
        b, e, m, spans = flat.setdefault(w, ([], [], [], []))
        spans.append((col, len(b), len(b) + len(bases)))
        b += list(bases)
        e += list(exps)
        m += list(moduli)

    batches = list(flat.values())
    if isinstance(powm, partial) and powm.func is device_powm_grouped:
        # the device route: every width batch's generic rows in one launch
        results = device_powm_batches([(b, e, m) for b, e, m, _ in batches],
                                      *powm.args, **powm.keywords)
    else:
        results = [powm(b, e, m) for b, e, m, _ in batches]
    out: list = [None] * len(columns)
    for (_, _, _, spans), res in zip(batches, results):
        for col, lo, hi in spans:
            out[col] = res[lo:hi]
    for col, dup in alias.items():
        out[col] = list(out[dup])  # fresh list: no aliasing across columns
    return out
